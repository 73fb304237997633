from .kernel import ssd_path, ssd_scan_kernel, ssd_scan_plain
from .ops import ssd_decode_step, ssd_scan
from .ref import ssd_ref

__all__ = ["ssd_decode_step", "ssd_path", "ssd_ref", "ssd_scan", "ssd_scan_kernel",
           "ssd_scan_plain"]
