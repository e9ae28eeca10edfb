"""Fault-tolerant checkpointing of trees of tensors: the port of
``repro/checkpoint/manager.py``.

* atomic: write to ``step_N.tmp`` then rename — a crash mid-save never
  corrupts the latest valid checkpoint;
* async: the leaves are copied to host memory when ``save`` is called (the
  train step updates its tensors in place afterwards), and written on a
  background thread; the train loop only blocks if a previous save is
  still in flight (one save in flight);
* unsharded: each leaf is saved whole as a numpy array in ``leaves.npz``
  (bfloat16 as its 16 bits), with ``meta.json`` holding each leaf's key
  path (in place of the reference's treedef string) and dtype; ``restore``
  puts every leaf on the device and dtype of the matching leaf of the
  tree it is given;
* mesh-elastic: a DTensor leaf (the model on a mesh) is saved whole, its
  full tensor gathered on every rank; rank 0 writes, blocking, and the
  other ranks wait at a barrier until the checkpoint is published (every
  rank calls ``save``, SPMD).  ``restore`` places each leaf as its
  like-leaf is placed, on the like-leaf's mesh: a re-shard onto any mesh
  (the reference's ``device_put`` against each like-leaf's sharding);
* retention: keep the last ``keep`` checkpoints, delete older ones.

A tree is nested dicts, lists, tuples and named tuples (``OptState``) over
tensors; numbers and numpy arrays are leaves too (saved as arrays,
restored as tensors).  The JAX package's checkpoints are not read.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix="") -> Iterator[Tuple[str, Any]]:
    """``(key path, leaf)``: dict keys sorted (the order ``jax.tree``
    flattens them), sequence items by index, named tuple items by field
    name."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix or "/", tree


def _rebuild(like, leaves: Iterator):
    """``like``'s structure with its leaves taken from ``leaves`` in
    :func:`_flatten`'s order."""
    if isinstance(like, dict):
        new = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _to_host(x) -> np.ndarray:
    """A copy of ``x`` in host memory (bfloat16 as its 16 bits, int16); a
    DTensor's full tensor (a collective)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if _is_dtensor(x):
            x = x.full_tensor()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        self.wait()                       # one save in flight
        flat = list(_flatten(tree))
        paths = [p for p, _ in flat]
        dtypes = [_dtype_name(x) for _, x in flat]
        host_leaves = [_to_host(x) for _, x in flat]
        if any(_is_dtensor(x) for _, x in flat):
            # a tree on a mesh: every rank gathered it; one rank writes
            import torch.distributed as tdist
            try:
                if tdist.get_rank() == 0:
                    self._write(step, paths, dtypes, host_leaves)
            finally:                  # a failed write raises on rank 0
                tdist.barrier()       # without stranding the others
            return

        if self.async_save and not blocking:
            def _run():
                try:
                    self._write(step, paths, dtypes, host_leaves)
                except BaseException as e:    # raised again by wait()
                    self._error = e
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        else:
            self._write(step, paths, dtypes, host_leaves)

    def _write(self, step, paths, dtypes, host_leaves) -> None:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "leaves.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "n_leaves": len(host_leaves),
                       "paths": paths, "dtypes": dtypes,
                       "time": time.time()}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)         # atomic publish
        self._gc()

    def wait(self) -> None:
        """Block until the save in flight (if any) is published; raises
        the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ---------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = list(self.latest_steps())
        return max(steps) if steps else None

    def restore(self, step: Optional[int], like: Any) -> Tuple[int, Any]:
        """Restore checkpoint ``step`` (the latest if None) into the
        structure of ``like``: each leaf a tensor on the device and in the
        dtype of ``like``'s leaf at the same key path (a non-tensor leaf
        of ``like`` gives a CPU tensor of the saved dtype); where that leaf
        is a DTensor, a DTensor on its mesh with its placements."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "leaves.npz")) as z:
            host_leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
        like_flat = list(_flatten(like))
        if [p for p, _ in like_flat] != meta["paths"]:
            raise ValueError(
                f"checkpoint step {step} holds {meta['n_leaves']} leaves at "
                f"other key paths than the {len(like_flat)} given")
        out: List[torch.Tensor] = []
        for h, dtype, (_, ref) in zip(host_leaves, meta["dtypes"], like_flat):
            t = torch.from_numpy(h)
            if dtype == "bfloat16":
                t = t.view(torch.bfloat16)
            if _is_dtensor(ref):
                from torch.distributed.tensor import distribute_tensor
                t = distribute_tensor(
                    t.to(device=ref.device_mesh.device_type,
                         dtype=ref.dtype), ref.device_mesh, ref.placements)
            elif isinstance(ref, torch.Tensor):
                t = t.to(device=ref.device, dtype=ref.dtype)
            out.append(t)
        return step, _rebuild(like, iter(out))

    def _gc(self) -> None:
        steps = sorted(self.latest_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def latest_steps(self):
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    yield int(name.split("_")[1])
                except ValueError:
                    pass
