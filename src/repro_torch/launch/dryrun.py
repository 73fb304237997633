"""The dry run (``repro.launch.dryrun``): every (architecture x input shape)
cell's production step at full width, depth and shape on the single-pod
``(16, 16)`` and the multi-pod ``(2, 16, 16)`` mesh, counted without
running it.  The reference lowers and compiles each step and reads XLA's
``memory_analysis()``, ``cost_analysis()`` and the compiled HLO's
collectives; the port builds the same step on the ``meta`` device, whose
tensors carry shapes and dtypes and no storage, runs it there (nothing is
computed, nothing allocated) and counts it under dispatch modes.

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out dryrun_torch_results.jsonl

A record holds, per device (one rank of the production mesh):

* ``memory`` (GB of 2**30 bytes, unrounded; ``memory_bytes`` the same in
  bytes): ``argument_gb``, one rank's share of everything the step is
  called with (training: the FSDP-stored float32 params, the AdamW
  moments, the step counter and the rank's batch rows; prefill: the params
  in the model dtype and the tokens; decode: the params, the caches and
  the tokens), each leaf's global bytes over the mesh axes its storage
  spec splits it by; ``temp_gb``, the peak of the bytes created and still
  live while the step runs, over tp; ``output_gb``, the results;
  ``alias_gb``, the arguments the step updates in place;
* ``cost``: ``flops`` from ``torch.utils.flop_counter.FlopCounterMode``
  (its formulas count products, convolutions and attention; elementwise
  work counts nothing), and ``bytes_accessed``, each op's input plus output
  bytes (a view moves none), the counterpart of XLA's "bytes accessed".
  Kernels D, E and F run on ``meta`` as the card runs them, each as one
  dispatcher op with a flop formula of its own (``kernels/matmul/ops.py``,
  ``kernels/flash_attention/ops.py``, ``kernels/ssd/ops.py``), so the
  count holds a kernel's own operands and result, not its plain version's
  intermediates (E's S x S scores); E's and F's backward is their plain
  version's, recomputed, on the card as here;
* ``collectives``: the channel ledger, one rank's steps and bytes per tag
  (``by_tag``) and the bytes in all (``total``);
* ``stack``: the one card's own figures, the rank stack's state and input
  bytes and its predicted peak (``chip_smoke.py`` phase 57 holds them
  against a run on the card).

How each is counted:

* **One data group.**  Every group runs the same program on its own rows
  (the reference's one SPMD program), so the step runs group 0 alone
  (``mesh.api.group_runner``), counts its FLOPs and bytes once for every
  group, and hands its result on as the others'.  The ledger counts group
  0, as in any run.
* **Layer periods.**  The step is counted at 2 and 3 layer periods (with
  the remainder layers; training 4 too, :data:`PROBE_PERIODS`) and a total
  extrapolated from their differences, the reference's ``full +
  (n_periods - 1) * probe`` with a second-order term for training's
  stacked-leaf gradients: exact where every period runs the same ops
  (tests hold it at smoke depth); an estimate for the peak, and where a
  ring pads a small leaf stored whole (``"grad"``) by its size.  An arch
  no deeper than the probes is counted whole.
* **The rank stack.**  The port computes every rank of the model axis on
  one stack, so a per-device figure is the stack's count over ``groups x
  tp`` (``groups`` the data groups the program stood for: one where a
  prefill's or decode's batch does not split, the reference's ``b_ok``).
  Work on a rank-stacked tensor divides exactly.  Work the stack does once
  for every rank is under-counted by that division where each device of
  the reference repeats it: the update and gradient sums of leaves stored
  once (replicated over the model axis), the MoE routing and the SSM's B
  and C computed from rank 0's gathered view, the loss on rank 0's copy.

The per-device and the stack's figures never need the storage: the
parameters come from ``models.param_shapes`` (no generator), laid out by
``interop.shard_params`` and ``optim.adamw_init`` on ``meta``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import COMM_MODES, SHAPES, ShapeConfig, cells, get_arch
from ..interop import param_specs, shard_params
from ..mesh.api import batch_axes_of, check_fsdp, group_runner, mesh_sizes, run_groups
from ..models import lm_caches, param_shapes
from ..models.common import tree_flatten, tree_map_specs
from ..models.model import model_dtype
from ..optim import adamw_init
from ..parallel import ledger
from .mesh import make_production_mesh
from .steps import TrainSettings, build_prefill, build_serve, build_train

META = torch.device("meta")


def _aliases(func) -> bool:
    """Whether an op's results alias its inputs (a view, or in place)."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _Counts(TorchDispatchMode):
    """Bytes accessed and the peak of live storage bytes of the ops run in
    the block: each op's input and output tensors' bytes (none for a view),
    and every storage an op creates held until it is freed (a weak
    reference to the storage; arguments made before the block are not
    counted)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func):
            self.bytes += sum(t.nbytes for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        if not _aliases(func):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._hold(t.untyped_storage())
        return out

    def _hold(self, st):
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n):
        self.live -= n


def _count_run(run, *, one_group: bool = True) -> dict:
    """``run()`` under the counters and a ledger capture, one data group
    counted for all (:func:`~repro_torch.mesh.api.group_runner`; every
    group run with ``one_group=False``): ``{"flops", "bytes", "temp",
    "groups", "by_tag"}`` of the rank stack."""
    extra = {"flops": 0, "bytes": 0, "groups": 1}
    fc = FlopCounterMode(display=False)
    counts = _Counts()

    def runner(n, fn):
        extra["groups"] = max(extra["groups"], n)
        if not one_group:
            with group_runner(None):
                return run_groups(n, fn)
        f0, b0 = fc.get_total_flops(), counts.bytes
        first = fn(0)
        extra["flops"] += (n - 1) * (fc.get_total_flops() - f0)
        extra["bytes"] += (n - 1) * (counts.bytes - b0)
        return [first] * n

    with ledger.capture() as led, group_runner(runner), fc, counts:
        run()
    by_tag = {t: dict(e) for t, e in led.by_tag.items()}
    return {"flops": fc.get_total_flops() + extra["flops"], "bytes": counts.bytes + extra["bytes"],
            "temp": counts.peak, "groups": extra["groups"], "by_tag": by_tag,
            "coll": sum(e["bytes"] for e in by_tag.values())}


def _shard(spec, sizes) -> int:
    """How many ranks a leaf's storage spec splits it over."""
    n = 1
    for d in tuple(spec):
        for a in (d if isinstance(d, tuple) else (d,)) if d is not None else ():
            n *= sizes[a]
    return n


def _per_device(tree, specs, sizes) -> int:
    """One rank's bytes of a tree of global leaves laid out by ``specs``."""
    return sum(tree_flatten(tree_map_specs(lambda t, sp, _: t.nbytes // _shard(sp, sizes),
                                           tree, specs)))


def _nbytes(tree) -> int:
    return sum(t.nbytes for t in tree_flatten(tree))


def _rows_split(n_rows: int, dp: int) -> int:
    """The data groups a batch of ``n_rows`` splits over (1 when it does
    not split: every group holds all of it, the reference's ``b_ok``)."""
    return dp if dp > 1 and n_rows % dp == 0 else 1


@dataclasses.dataclass
class _Step:
    """One cell's step on ``meta``: ``run()`` and what it is called with."""

    run: object
    ctx: object
    state: dict          # the stacked state the step takes (params, opt or caches)
    inputs: dict         # the step's other inputs (the batch's tensors)


def _inputs(ispecs) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device=META) for k, v in ispecs.items()}


def _build(cfg, shape, mesh, *, comm_mode, settings, shared_gather, ring_attn, remat, fsdp):
    """The cell's step for ``cfg`` (a depth cut of the arch) on ``meta``."""
    from ..kernels.matmul import matmul

    if shape.kind == "train":
        st = settings or TrainSettings(comm_mode=comm_mode, shared_gather=shared_gather,
                                       ring_attn=ring_attn, remat=remat)
        tp = mesh_sizes(mesh).get("model", 1)
        art = build_train(cfg, shape, st, mesh=mesh, matmul_fn=matmul if tp > 1 else None,
                          device=META)
        ctx = art["ctx"]
        params = shard_params(param_shapes(cfg, ctx), cfg, ctx, art["plan"])
        for p in tree_flatten(params):
            p.requires_grad_(True)
        state = {"params": params, "opt": adamw_init(params)}
        batch = _inputs(art["input_specs"])
        return _Step(lambda: art["step"](state, batch), ctx, state, batch), art["plan"]
    dtype = model_dtype(cfg)
    if shape.kind == "prefill":
        pf = build_prefill(cfg, shape, mesh=mesh, comm_mode=comm_mode,
                           shared_gather=shared_gather, ring_attn=ring_attn, fsdp=fsdp,
                           device=META)
        from ..data import input_specs

        params = shard_params(param_shapes(cfg, pf.ctx, dtype), cfg, pf.ctx, pf.plan)
        inputs = _inputs(input_specs(cfg, shape))
        return _Step(lambda: pf(params, *inputs.values()), pf.ctx, {"params": params},
                     inputs), pf.plan
    sv = build_serve(cfg, shape, mesh=mesh, comm_mode=comm_mode, fsdp=fsdp, device=META)
    ctx = sv["ctx"]
    params = shard_params(param_shapes(cfg, ctx, dtype), cfg, ctx, sv["plan"])
    caches = lm_caches(cfg, shape.global_batch, shape.seq_len, ctx, META)
    tok = (shape.global_batch, cfg.n_codebooks) if cfg.n_codebooks > 1 else (shape.global_batch,)
    inputs = {"token": torch.empty(tok, dtype=torch.int32, device=META),
              "pos": torch.empty((), dtype=torch.int32, device=META)}
    return _Step(lambda: sv["step"](params, caches, inputs["token"], inputs["pos"]), ctx,
                 {"params": params, "caches": caches}, inputs), sv["plan"]


#: the periods a cell's probes run: two, three and (training) four.  Not
#: one: a stacked ``(1, ...)`` leaf is contiguous where a deeper stack's
#: layer slices are not, and some of their copies fall away
PROBE_PERIODS = (2, 3, 4)


def _depths(cfg, kind: str) -> tuple[int, ...]:
    """The depths a cell is counted at: two and three layer periods (with
    the remainder layers), and four for training (its backward's bytes
    grow with the square of the depth: each layer's gradient of a stacked
    ``(L, ...)`` leaf is a whole ``(L, ...)`` tensor, summed over the
    layers); the whole depth where it is no deeper than the probes."""
    period = len(cfg.pattern)
    n_periods, rem = divmod(cfg.n_layers, period)
    probes = PROBE_PERIODS if kind == "train" else PROBE_PERIODS[:2]
    if n_periods <= probes[-1]:
        return (cfg.n_layers,)
    return tuple(k * period + rem for k in probes)


def _assemble(got: list, n_periods: int):
    """The total at ``n_periods`` periods of the counts at the probes'
    (:data:`PROBE_PERIODS`): ``c + k d1 + k (k - 1) / 2 d2``, ``c`` the
    first probe's, ``k`` the periods past it and ``d1``, ``d2`` the first
    and second differences (the reference's ``full + (n_periods - 1) *
    probe`` where ``d2`` is 0)."""
    k = n_periods - PROBE_PERIODS[0]

    def total(*c):
        d1 = c[1] - c[0]
        d2 = c[2] - 2 * c[1] + c[0] if len(c) > 2 else 0
        return c[0] + k * d1 + k * (k - 1) // 2 * d2

    tags = {}
    for t in sorted(set().union(*(g["by_tag"] for g in got))):
        es = [g["by_tag"].get(t, {"steps": 0, "bytes": 0}) for g in got]
        tags[t] = {f: total(*(e[f] for e in es)) for f in ("steps", "bytes")}
    out = {f: total(*(g[f] for g in got)) for f in ("flops", "bytes", "temp", "coll")}
    out.update(groups=got[0]["groups"], by_tag=tags,
               period={f: got[1][f] - got[0][f] for f in ("flops", "bytes", "coll")})
    return out


def count_step(cfg, shape, mesh, *, comm_mode: str = "smi", settings=None,
               shared_gather: bool = False, ring_attn: bool = False,
               remat: str = "nothing", fsdp=None, whole: bool = False) -> dict:
    """The rank stack's counts of ``cfg``'s step for ``shape`` on ``mesh``
    (a mesh tuple), assembled from one data group and one and two layer
    periods (``whole=True``: the whole step, every group at full depth):
    ``{"flops", "bytes", "temp", "groups", "by_tag", "coll", "period"}``,
    ``period`` one more period's flops, bytes and collective bytes between
    the first two probes (the whole step's share of one period where the
    arch is no deeper than the probes).  ``fsdp`` (None: the builders'
    ``"auto"``, resolved for the whole arch) holds at every depth."""
    if fsdp is None:
        fsdp = check_fsdp("auto", mesh, cfg.param_count())
    n_periods = cfg.n_layers // len(cfg.pattern)
    got = []
    for depth in (cfg.n_layers,) if whole else _depths(cfg, shape.kind):
        step, _ = _build(cfg.scaled(n_layers=depth), shape, mesh, comm_mode=comm_mode,
                         settings=settings, shared_gather=shared_gather, ring_attn=ring_attn,
                         remat=remat, fsdp=fsdp)
        got.append(_count_run(step.run, one_group=not whole))
        del step
    if len(got) > 1:
        return _assemble(got, n_periods)
    one = got[0]
    return {**one, "period": {f: one[f] / max(n_periods, 1) for f in ("flops", "bytes", "coll")}}


def _arguments(cfg, shape, mesh, *, comm_mode, settings, shared_gather, ring_attn, remat,
               fsdp) -> dict:
    """The step's arguments at full depth, on ``meta``: one rank's bytes
    of its state, inputs, results and in-place updates, and the rank
    stack's state and input bytes."""
    step, plan = _build(cfg, shape, mesh, comm_mode=comm_mode, settings=settings,
                        shared_gather=shared_gather, ring_attn=ring_attn, remat=remat, fsdp=fsdp)
    ctx = step.ctx
    sizes = mesh_sizes(mesh)
    tp, dp = ctx.tp, ctx.dp
    pspecs = param_specs(cfg, ctx, plan)
    gshapes = param_shapes(cfg, ctx, torch.float32 if shape.kind == "train" else model_dtype(cfg))
    params = _per_device(gshapes, pspecs, sizes)
    n_rows = shape.global_batch
    split = _rows_split(n_rows, dp)
    inputs = sum(t.nbytes // (split if t.dim() else 1) for t in step.inputs.values())
    if shape.kind == "train":
        state = 3 * params + 4                     # params, m, v (float32) and the step
        output = state + 4 * 4                     # the state and loss, ce, gnorm, lr
        alias = state
    elif shape.kind == "prefill":
        state = params
        hidden = n_rows * shape.seq_len * cfg.d_model * model_dtype(cfg).itemsize
        output, alias = hidden // (split * tp), 0
    else:
        caches = _nbytes(step.state["caches"]) // (split * tp)
        state = params + caches
        vocab = cfg.padded_vocab * max(cfg.n_codebooks, 1)
        output = n_rows * vocab * 4 // (split * tp) + caches
        alias = caches
    stack = {"state_bytes": _nbytes(step.state), "input_bytes": _nbytes(step.inputs),
             "tp": tp, "dp": dp}
    return {"argument": state + inputs, "output": output, "alias": alias, "stack": stack}


def dry_run(cfg, shape: ShapeConfig, mesh, *, comm_mode: str = "smi",
            settings: TrainSettings | None = None, shared_gather: bool = False,
            ring_attn: bool = False, remat: str = "nothing") -> dict:
    """The counted fields of a record (module docstring) for ``cfg``'s step
    on ``shape`` over ``mesh``, a mesh tuple (``(1,)``: tp = 1): ``memory``,
    ``memory_bytes``, ``cost``, ``collectives``, ``period_probe``,
    ``stack``, ``settings`` and ``count_s``, the host seconds counting
    took."""
    t0 = time.time()
    mesh = tuple(int(n) for n in mesh)
    fsdp = check_fsdp("auto", mesh, cfg.param_count())   # prefill and decode
    kw = dict(comm_mode=comm_mode, settings=settings, shared_gather=shared_gather,
              ring_attn=ring_attn, remat=remat)
    counts = count_step(cfg, shape, mesh, fsdp=fsdp, **kw)
    args = _arguments(cfg, shape, mesh, fsdp=fsdp, **kw)
    tp = mesh_sizes(mesh).get("model", 1)
    per = counts["groups"] * tp
    mem = {"argument": args["argument"], "output": args["output"],
           "temp": counts["temp"] // tp, "alias": args["alias"]}
    stack = args["stack"]
    return {
        "count_s": time.time() - t0,
        "memory": {f"{k}_gb": v / 2**30 for k, v in mem.items()},
        "memory_bytes": mem,
        "cost": {"flops": counts["flops"] / per, "bytes_accessed": counts["bytes"] / per},
        "collectives": {"by_tag": counts["by_tag"], "total": counts["coll"]},
        "period_probe": {k: v / (per if k != "coll" else 1)
                         for k, v in counts["period"].items()},
        "stack": {**stack, "groups": counts["groups"], "flops": counts["flops"],
                  "bytes_accessed": counts["bytes"], "temp_bytes": counts["temp"],
                  "peak_bytes": stack["state_bytes"] + stack["input_bytes"] + counts["temp"]},
        "settings": {"remat": (settings.remat if settings else remat)
                     if shape.kind == "train" else "nothing",
                     "shared_gather": settings.shared_gather if settings else shared_gather,
                     "ring_attn": settings.ring_attn if settings else ring_attn},
        "batch_axes": list(batch_axes_of(mesh)),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, comm_mode: str = "smi",
             settings: TrainSettings | None = None, shared_gather: bool = False,
             ring_attn: bool = False, remat: str = "nothing", variant: str = "base",
             verbose: bool = True) -> dict:
    """One cell's record on the production mesh (the reference's keys and
    :func:`dry_run`'s).  A failing cell is ``ok: False`` with its error
    and traceback; ``long_500k`` of a pure full-attention arch is skipped."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    dims, _ = make_production_mesh(multi_pod=multi_pod)
    rec: dict = {"arch": arch, "shape": shape_name, "kind": shape.kind,
                 "mesh": "x".join(map(str, dims)), "comm_mode": comm_mode, "variant": variant,
                 "ok": False}
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        rec["skipped"] = "pure full-attention arch (DESIGN.md §4)"
        rec["ok"] = True
        return rec
    try:
        rec.update(dry_run(cfg, shape, dims, comm_mode=comm_mode, settings=settings,
                           shared_gather=shared_gather, ring_attn=ring_attn, remat=remat))
        rec["ok"] = True
        if verbose:
            print(f"[dryrun] {arch} {shape_name} mesh={rec['mesh']} mode={comm_mode} OK "
                  f"count={rec['count_s']:.1f}s arg={rec['memory']['argument_gb']:.3f}GB "
                  f"temp={rec['memory']['temp_gb']:.3f}GB flops={rec['cost']['flops']:.3g} "
                  f"coll={rec['collectives']['total']:.3g}B", flush=True)
    except Exception as e:  # noqa: BLE001 -- a failing cell is a bug report
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} {shape_name} mesh={rec['mesh']} FAILED: {rec['error']}",
                  flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--comm-mode", default="smi", choices=list(COMM_MODES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_torch_results.jsonl")
    args = ap.parse_args(argv)

    todo = [(a, s) for a, s, _ in cells()
            if (not args.arch or a == args.arch) and (not args.shape or s == args.shape)]
    if not todo or not (args.all or args.arch or args.shape):
        print("nothing selected (name --arch/--shape, or --all)", file=sys.stderr)
        return 1
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    results = []
    for arch, shape_name in todo:
        for mp in meshes:
            rec = run_cell(arch, shape_name, multi_pod=mp, comm_mode=args.comm_mode)
            results.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    n_bad = sum(1 for r in results if not r["ok"])
    print(f"[dryrun] {len(results) - n_bad}/{len(results)} cells OK")
    return 0 if n_bad == 0 else 2


if __name__ == "__main__":
    sys.exit(main())
