"""Atomic, manifest-verified, asynchronous checkpoints
(``repro.checkpoint.checkpointer``), in the reference's layout.

Layout: ``<dir>/step_<N:08d>/``

* ``manifest.json``: ``step``, ``treedef`` (the tree's structure, as
  :func:`tree_structure` writes it), ``n_leaves``, ``shapes``, ``dtypes``,
  ``extra``;
* ``arrays.npz``: the leaves as ``leaf_<i>``, ``i`` in ``jax.tree.flatten``'s
  order (dict keys sorted, tuples in order, ``None`` no leaf:
  :func:`~repro_torch.models.common.tree_flatten`).

A save stages into ``step_<N>.tmp`` and renames it (atomic on POSIX), so a
crash mid-save never corrupts the restore point, and keeps the newest
``keep`` checkpoints.  An asynchronous save copies the leaves to host
memory first and hands them to a writer thread.  Leaves are saved as they
are given: the training loop hands it the global state
(:func:`~repro_torch.interop.unshard_train_state`), so a checkpoint holds
the same arrays at any tensor-parallel degree.  bfloat16 leaves are saved
widened to float32 (numpy has no bfloat16) and cast back on restore.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..models.common import tree_flatten, tree_unflatten


def tree_structure(tree) -> str:
    """The structure of a tree as a string: dicts, tuples, ``None`` and
    ``*`` for a leaf, dict keys sorted."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_structure(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(tree_structure(t) for t in tree) + ("," if len(tree) == 1 else "") + ")"
    return "None" if tree is None else "*"


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy().copy()
    return np.array(leaf, copy=True)


class Checkpointer:
    """Saves and restores trees of tensors or numpy arrays under
    ``directory``, keeping the newest ``keep`` steps."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None

    def save(self, state, step: int, *, extra: dict | None = None, async_: bool = False):
        """Snapshot ``state`` at ``step``; with ``async_`` the write runs on a
        thread (a second save, :meth:`wait` and :meth:`restore` wait for
        it)."""
        host = [_to_host(leaf) for leaf in tree_flatten(state)]
        structure = tree_structure(state)
        if async_:
            self.wait()
            t = threading.Thread(target=self._write, args=(host, structure, step, extra),
                                 daemon=True)
            t.start()
            self._pending = t
        else:
            self._write(host, structure, step, extra)

    def _write(self, host, structure, step, extra):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **{f"leaf_{i}": a for i, a in enumerate(host)})
        manifest = {"step": step, "treedef": structure, "n_leaves": len(host),
                    "shapes": [list(a.shape) for a in host],
                    "dtypes": [str(a.dtype) for a in host], "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def steps(self) -> list:
        return sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                      if n.startswith("step_") and not n.endswith(".tmp"))

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    def restore(self, state_like, step: int | None = None):
        """The checkpoint at ``step`` (the latest when ``None``) in the
        structure of ``state_like``, each leaf's shape checked against it.
        Returns ``(host numpy tree, manifest)``; the caller lays it onto its
        device, dtypes and mesh (:func:`~repro_torch.ft.reshard_state`)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
        ref = tree_flatten(state_like)
        if len(ref) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, expected {len(ref)}")
        for i, (a, r) in enumerate(zip(leaves, ref)):
            if tuple(a.shape) != tuple(r.shape):
                raise ValueError(f"leaf {i}: checkpoint {a.shape} vs expected {tuple(r.shape)}")
        return tree_unflatten(state_like, leaves), manifest
