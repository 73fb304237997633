"""smilint AST rules: source-level lints over the port's tree
(``repro.analysis.rules``).

The static half of the rule catalog — no capture, just ``ast`` over the
files the CLI sweeps (``src/repro_torch/`` and ``chip_smoke.py``):

* **SMI001** — deprecated ``stream_*`` collective shims;
* **SMI002** — a port-claiming ``open_*_channel`` call outside the
  ``with``/close discipline: the claim leaks until the opening channel is
  garbage-collected (anonymous ``port=None`` opens hold no claim and are
  exempt);
* **SMI003** — a hardcoded port literal inside the serving pool's
  reserved range (``ChannelPool`` assigns 100+ sequentially), or a
  serving-prefixed tag literal, outside the serving/channels/launch
  layers: the next engine start collides with it;
* **SMI004** — a raw move over the rank dimension in ``models``/
  ``parallel``/``serving``, bypassing the tagged channel layer
  (``parallel/layers.py`` is the one allowed site: it *is* the layer).
  The port's raw moves are the rank-dimension primitives of
  ``core/comm.py`` and the ``torch.distributed`` collectives (see
  :class:`NoRawCollectives`).

The scopes are the reference's with ``src/repro/`` renamed
``src/repro_torch/``; SMI004 is the one rule whose pattern changes.
Suppression: a ``# smilint: ignore[RULE]`` (or ``ignore[RULE1,RULE2]``)
comment on the flagged line silences exactly those rules there.
"""

from __future__ import annotations

import ast
import pathlib
import re
from dataclasses import dataclass, field

from .verify import Diagnostic

#: ``# smilint: ignore[SMI001]`` / ``ignore[SMI001,SMI104]``
_SUPPRESS = re.compile(r"#\s*smilint:\s*ignore\[([A-Za-z0-9_,\s]+)\]")

#: the serving pool's reserved port range: ``ChannelPool(base_port=100)``
#: claims sequentially upward; the reference budgets it one hundred ports
RESERVED_PORTS = range(100, 200)

#: the serving pool's tag namespace (``ChannelPool(prefix="serve.")``)
RESERVED_TAG_PREFIX = "serve."

#: the port-claiming channel-open family SMI002/SMI003 watch
OPEN_CALLS = ("open_channel", "open_bcast_channel", "open_reduce_channel",
              "open_scatter_channel", "open_gather_channel",
              "open_allreduce_channel")


@dataclass
class SourceFile:
    """One file under lint: text, parse tree, suppression map."""

    path: pathlib.Path
    relpath: str  # posix, relative to the sweep root
    text: str
    _tree: object = field(default=None, repr=False)
    _suppressed: dict | None = field(default=None, repr=False)

    @classmethod
    def load(cls, path: pathlib.Path, root: pathlib.Path) -> "SourceFile":
        rel = pathlib.PurePosixPath(path.relative_to(root).as_posix())
        return cls(path=path, relpath=str(rel), text=path.read_text())

    @property
    def lines(self) -> list:
        return self.text.splitlines()

    @property
    def tree(self):
        if self._tree is None:
            self._tree = ast.parse(self.text, filename=str(self.path))
            for node in ast.walk(self._tree):
                for child in ast.iter_child_nodes(node):
                    child._smilint_parent = node
        return self._tree

    def suppressed(self, lineno: int, rule: str) -> bool:
        if self._suppressed is None:
            sup: dict[int, set] = {}
            for i, line in enumerate(self.lines, start=1):
                m = _SUPPRESS.search(line)
                if m:
                    sup[i] = {r.strip() for r in m.group(1).split(",")}
            self._suppressed = sup
        return rule in self._suppressed.get(lineno, ())

    def diag(self, rule: str, lineno: int, message: str, **kw):
        return Diagnostic(rule=rule, message=message,
                          location=f"{self.relpath}:{lineno}", **kw)


class Rule:
    """One AST/source rule.  Subclasses set ``rule_id`` and implement
    :meth:`check`; :meth:`applies` scopes the rule by repo path."""

    rule_id = ""

    def applies(self, relpath: str) -> bool:
        return True

    def check(self, src: SourceFile) -> list:
        raise NotImplementedError


# -- SMI001: deprecated stream_* shims ---------------------------------------


class NoStreamShims(Rule):
    """The ``stream_*`` wrappers are deprecated; the channels API is the
    supported surface: any reference in the port's tree outside the
    shims' definition site and re-export is a regression."""

    rule_id = "SMI001"

    SHIMS = ("stream_bcast", "stream_reduce", "stream_gather",  # smilint: ignore[SMI001]
             "stream_scatter", "stream_allreduce")  # smilint: ignore[SMI001]
    PAT = re.compile(r"\b(" + "|".join(SHIMS) + r")\b")

    #: definition site + the package re-export keeping the shims importable
    #: + this rule catalog and its seeded-defect corpus, which must be able
    #: to *name* the shims they hunt
    ALLOWED = ("src/repro_torch/core/collectives.py", "src/repro_torch/core/__init__.py",
               "src/repro_torch/analysis/rules.py", "src/repro_torch/analysis/corpus.py")

    def applies(self, relpath: str) -> bool:
        return (relpath.startswith("src/repro_torch/") or relpath == "chip_smoke.py") \
            and relpath not in self.ALLOWED

    def check(self, src: SourceFile) -> list:
        diags = []
        for lineno, line in enumerate(src.lines, start=1):
            m = self.PAT.search(line)
            if m:
                diags.append(src.diag(
                    self.rule_id, lineno,
                    f"deprecated shim {m.group(1)}() — use the channels "
                    "API (repro_torch.channels.open_*_channel / ChannelSpec)",
                ))
        return diags


# -- SMI002: open outside with/close discipline ------------------------------


def _kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_none(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _enclosing_scope(node):
    cur = getattr(node, "_smilint_parent", None)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
        cur = getattr(cur, "_smilint_parent", None)
    return cur


class CloseDiscipline(Rule):
    """A port-claiming open must be scoped: a ``with`` block, an explicit
    ``.close()`` on the bound name, or an escape (returned / yielded /
    passed on / stored on an object) that hands the obligation to the
    caller.  A bare open leaves the claim to the garbage collector —
    exactly the non-determinism the PortAllocator's weakref lifecycle
    exists to paper over, and persistent claims never lapse at all."""

    rule_id = "SMI002"

    def applies(self, relpath: str) -> bool:
        # the channels layer itself constructs channels it hands out
        return not relpath.startswith("src/repro_torch/channels/")

    def check(self, src: SourceFile) -> list:
        diags = []
        for node in ast.walk(src.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in OPEN_CALLS):
                continue
            if _is_none(_kwarg(node, "port")):
                continue  # anonymous: no claim, nothing to leak
            if self._disciplined(node):
                continue
            diags.append(src.diag(
                self.rule_id, node.lineno,
                f"{node.func.id}(...) claims a port outside the "
                "with/close discipline — wrap it in `with`, call "
                ".close(), or open with port=None",
            ))
        return diags

    def _disciplined(self, call: ast.Call) -> bool:
        parent = getattr(call, "_smilint_parent", None)
        # with open_*(...) as ch: — the canonical form
        if isinstance(parent, ast.withitem):
            return True
        # escapes: return/yield it, pass it on, store it on an object —
        # the claim's lifetime is the caller's / owner's business
        if isinstance(parent, (ast.Return, ast.Yield, ast.YieldFrom,
                               ast.Call, ast.keyword, ast.Tuple, ast.List,
                               ast.Dict, ast.Starred)):
            return True
        # ch = open_*(...): look for ch.close() / an escape of ch in the
        # enclosing scope
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            target = parent.targets[0]
            if isinstance(target, (ast.Attribute, ast.Subscript)):
                return True  # stored on an object: ownership transferred
            if isinstance(target, ast.Name):
                return self._name_released(call, target.id)
        if isinstance(parent, (ast.AnnAssign, ast.NamedExpr)) and \
                isinstance(getattr(parent, "target", None), ast.Name):
            return self._name_released(call, parent.target.id)
        return False

    def _name_released(self, call: ast.Call, name: str) -> bool:
        scope = _enclosing_scope(call)
        if scope is None:
            return False
        for node in ast.walk(scope):
            # ch.close() — possibly rebound through loop carries first,
            # so any .close() on the name counts
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "close"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == name):
                return True
            # return ch / yield ch (alone or inside a tuple)
            if isinstance(node, (ast.Return, ast.Yield)) \
                    and node.value is not None:
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Name) and sub.id == name:
                        return True
        return False


# -- SMI003: reserved ports / tags -------------------------------------------


class ReservedPorts(Rule):
    """Ports 100–199 belong to the serving pool (``ChannelPool`` claims
    from ``base_port=100`` upward) and :data:`RESERVED_TAG_PREFIX` is its
    tag namespace;
    a literal in either, outside the serving/channels layer, collides
    with the next engine start."""

    rule_id = "SMI003"

    #: layers that legitimately speak the reserved namespace
    ALLOWED_PREFIXES = ("src/repro_torch/serving/", "src/repro_torch/channels/",
                        "src/repro_torch/launch/")

    def applies(self, relpath: str) -> bool:
        return not relpath.startswith(self.ALLOWED_PREFIXES)

    def check(self, src: SourceFile) -> list:
        diags = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = node.func
            name = callee.id if isinstance(callee, ast.Name) else (
                callee.attr if isinstance(callee, ast.Attribute) else None)
            if name in OPEN_CALLS + ("ChannelSpec", "claim"):
                port = _kwarg(node, "port")
                if isinstance(port, ast.Constant) \
                        and isinstance(port.value, int) \
                        and port.value in RESERVED_PORTS:
                    diags.append(src.diag(
                        self.rule_id, port.lineno,
                        f"hardcoded port {port.value} lies in the serving "
                        f"pool's reserved range "
                        f"[{RESERVED_PORTS.start}, {RESERVED_PORTS.stop}) "
                        "— the pool claims these sequentially at engine "
                        "start", port=port.value,
                    ))
            if name in OPEN_CALLS + ("ChannelSpec", "layer_spec"):
                tag = _kwarg(node, "tag")
                if isinstance(tag, ast.Constant) \
                        and isinstance(tag.value, str) \
                        and tag.value.startswith(RESERVED_TAG_PREFIX):
                    diags.append(src.diag(
                        self.rule_id, tag.lineno,
                        f"tag {tag.value!r} uses the serving pool's "
                        f"reserved {RESERVED_TAG_PREFIX!r} namespace "
                        "outside the serving layer", tag=tag.value,
                    ))
        return diags


# -- SMI004: raw moves over the rank dimension -------------------------------


class NoRawCollectives(Rule):
    """Model/parallel/serving code must move rank rows through the tagged
    channel layer (``layer_spec`` / ``psum_tagged`` / channel transfers) so
    the ledger, netsim predictions and smilint capture see them; a raw move
    is invisible traffic.

    The reference flags ``lax.psum``/``ppermute``/... .  The port has no
    ``lax``: its ranks are the leading dimension of one tensor, and a move
    between them is one of

    * the rank-dimension primitives of ``core/comm.py``: ``ppermute`` (the
      index copy every static step is), and the index helpers it gathers
      through, ``_full_gather`` and ``_pair_index`` — called by name or as
      an attribute (``comm.ppermute``, ``C.ppermute``);
    * a ``torch.distributed`` collective or point-to-point call
      (:data:`DIST_CALLS`), reached as ``torch.distributed.<f>``,
      ``dist.<f>`` or ``distributed.<f>``.
    """

    rule_id = "SMI004"

    #: the rank-dimension primitives of core/comm.py
    PRIMITIVES = ("ppermute", "_full_gather", "_pair_index")
    #: the torch.distributed calls that move tensors between ranks
    DIST_CALLS = ("all_reduce", "all_gather", "all_gather_into_tensor",
                  "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
                  "all_to_all", "all_to_all_single", "broadcast",
                  "broadcast_object_list", "reduce", "gather", "scatter", "send",
                  "recv", "isend", "irecv", "batch_isend_irecv")
    #: the names ``torch.distributed`` is reached through
    DIST_BASES = ("dist", "distributed")
    SCOPES = ("src/repro_torch/models/", "src/repro_torch/parallel/",
              "src/repro_torch/serving/")
    #: the tagged channel layer itself: the one place raw moves are the
    #: implementation, not a bypass
    ALLOWED = ("src/repro_torch/parallel/layers.py",)

    def applies(self, relpath: str) -> bool:
        return relpath.startswith(self.SCOPES) \
            and relpath not in self.ALLOWED

    def _raw(self, func) -> str | None:
        """The flagged call's name, or None."""
        if isinstance(func, ast.Name):
            return func.id if func.id in self.PRIMITIVES else None
        if not isinstance(func, ast.Attribute):
            return None
        if func.attr in self.PRIMITIVES:
            return func.attr
        base = func.value
        base_name = base.id if isinstance(base, ast.Name) else (
            base.attr if isinstance(base, ast.Attribute) else None)
        if func.attr in self.DIST_CALLS and base_name in self.DIST_BASES:
            return f"{base_name}.{func.attr}"
        return None

    def check(self, src: SourceFile) -> list:
        diags = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = self._raw(node.func)
            if name is None:
                continue
            diags.append(src.diag(
                self.rule_id, node.lineno,
                f"raw {name}(...) moves rank rows outside the tagged "
                "channel layer — use repro_torch.parallel.layers "
                "(layer_spec/psum_tagged) or a channel transfer",
            ))
        return diags


#: the registered rule set, catalog order
ALL_RULES = (NoStreamShims(), CloseDiscipline(), ReservedPorts(),
             NoRawCollectives())

#: directories the default sweep ignores entirely
_SKIP_PARTS = {".git", "__pycache__", ".ruff_cache", "build", "dist"}


def port_paths(root) -> list:
    """The port's tree under ``root``: every ``*.py`` of
    ``src/repro_torch`` and ``chip_smoke.py``."""
    root = pathlib.Path(root).resolve()
    paths = sorted((root / "src" / "repro_torch").rglob("*.py"))
    if (root / "chip_smoke.py").is_file():
        paths.append(root / "chip_smoke.py")
    return paths


def lint_paths(root, paths=None, rules=ALL_RULES) -> list:
    """Run the AST rules over ``paths`` (default: the port's tree,
    :func:`port_paths`), returning suppression-filtered diagnostics sorted
    by location."""
    root = pathlib.Path(root).resolve()
    if paths is None:
        paths = port_paths(root)
    diags = []
    for path in paths:
        path = pathlib.Path(path).resolve()
        if _SKIP_PARTS.intersection(path.parts):
            continue
        src = SourceFile.load(path, root)
        for rule in rules:
            if not rule.applies(src.relpath):
                continue
            for d in rule.check(src):
                lineno = int(d.location.rsplit(":", 1)[1])
                if not src.suppressed(lineno, d.rule):
                    diags.append(d)
    return sorted(diags, key=lambda d: (d.location or "", d.rule))


def lint_source(text: str, relpath: str = "src/repro_torch/seeded.py",
                rules=ALL_RULES) -> list:
    """Rule run over an in-memory source string (the corpus' AST seeds)."""
    src = SourceFile(path=pathlib.Path(relpath), relpath=relpath, text=text)
    diags = []
    for rule in rules:
        if rule.applies(relpath):
            for d in rule.check(src):
                lineno = int(d.location.rsplit(":", 1)[1])
                if not src.suppressed(lineno, d.rule):
                    diags.append(d)
    return sorted(diags, key=lambda d: (d.location or "", d.rule))
