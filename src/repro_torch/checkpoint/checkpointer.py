"""Chunked, manifest-driven checkpointing of the port:
``repro.checkpoint.checkpointer``, with the same layout on disk, so that
either package restores what the other wrote.

Layout:  <dir>/step_<N>/
             manifest.json      {step, leaves: [{key, shape, dtype}], extra}
             shard_0.npz        leaf arrays, keyed by leaf key with "/" -> "__"

A tree is nested dicts and NamedTuples with tensors or numpy arrays as
leaves, flattened in JAX's order and named by JAX's path keys: dict keys
sorted, a NamedTuple field as ".<name>", joined by "/". A TrainState in
the JAX package's layout (``training.train_step.state_tree``) thus gives ``.params/embed``,
``.params/units/u0/attn/wq``, ..., ``.opt/.step``, ``.opt/.master/...``,
``.opt/.m/...``, ``.opt/.v/...``, the keys the JAX package writes.

bf16: numpy has no bfloat16 without ml_dtypes (the card's host has none),
so a bf16 leaf is written as its raw 2-byte values (void ``V2``), which is
what ``np.savez`` writes for the JAX package's ml_dtypes bfloat16, and the
manifest names its dtype ``bfloat16``. ``restore`` reads ``V2`` back through
uint16 -> int16 -> ``torch.bfloat16``.

Guarantees:
  * atomic commit: written to step_<N>.tmp, fsynced, renamed;
  * async mode: the device -> host copy happens on the caller's thread, the
    file write on a background thread (training continues); ``wait()``
    joins it and raises what the write raised;
  * keep-N: after each commit only the newest ``keep`` steps remain.
Meshes: a sharded run gathers its state whole before it saves
(``training.state_tree``; rank 0 writes), so the files are a single-rank
run's. ``restore(..., mesh=, cfg=)`` gives each rank its slices of every
leaf, by the sharding rules of the mesh it restores onto, which need not be
the mesh that saved (the JAX ``restore(shardings=)``): save at (data,
model) = (1, 2), lose a rank or regroup, ``remesh``, restore, go on.
Leaves restore as CPU tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..models.bridge import is_bf16, to_numpy, to_tensor


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any, prefix: tuple = ()) -> list:
    """[(path key, leaf)] in JAX's flattening order with JAX's path keys."""
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten(getattr(tree, f), prefix + ("." + f,))]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k], prefix + (str(k),))]
    return [("/".join(prefix), tree)]


def unflatten(template: Any, leaves) -> Any:
    """`template`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if _is_namedtuple(template):
        return type(template)(*(unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, dict):
        out = {k: unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    return next(leaves)


def _host(leaf) -> np.ndarray:
    return to_numpy(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if is_bf16(arr) else str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             async_: bool = False):
        host = {}
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        for key, leaf in flatten(tree):
            arr = _host(leaf)
            host[key] = arr
            manifest["leaves"].append(
                {"key": key, "shape": list(arr.shape), "dtype": dtype_name(arr)})

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            shard = os.path.join(tmp, "shard_0.npz")
            np.savez(shard, **{k.replace("/", "__"): v for k, v in host.items()})
            with open(shard, "rb") as f:
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if async_:
            self.wait()

            def run():
                try:
                    write()
                except Exception as e:   # re-raised by wait() on the caller's thread
                    self._error = e

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def _steps(self) -> list:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None, mesh=None, cfg=None):
        """template: a tree of the target structure (its leaves' values are
        ignored). Returns (the tree with CPU tensors of the checkpoint's
        dtypes as leaves, the manifest). With a `mesh` (and the model's
        global `cfg`) the tree is a TrainState in the JAX layout and each
        leaf is this rank's slice of it (``sharding.train_tree_spec``)."""
        from ..distributed.sharding import shard, train_tree_spec
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = {le["key"]: le["dtype"] for le in manifest["leaves"]}
        leaves = []
        with np.load(os.path.join(d, "shard_0.npz")) as data:
            for key, _ in flatten(template):
                arr = data[key.replace("/", "__")]
                if arr.dtype.kind == "V" and dtypes.get(key) != "bfloat16":
                    raise ValueError(f"{key}: raw {arr.dtype} values of dtype "
                                     f"{dtypes.get(key)!r}; only bfloat16 is stored raw")
                if mesh is not None:
                    arr = shard(arr, train_tree_spec(mesh, cfg, key, arr.shape), mesh)
                leaves.append(to_tensor(arr))
        return unflatten(template, iter(leaves)), manifest

    def _gc(self):
        for s in self._steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
