"""Checkpointing: atomic tree save and restore with asynchronous writes and
resharding on load, the JAX package's ``checkpoint/checkpoint.py`` for trees
of tensors.

Layout (the same bytes as the JAX package's, so each package reads the
other's checkpoints): ``<dir>/step_<N:08d>/{manifest.json, arrays.npz}``,
written into ``step_<N>.tmp`` and then renamed, so a crash mid-write never
leaves a half checkpoint under a step's name.  A leaf's key is its path
(``tree_util``), each key ``str(getattr(k, "key", getattr(k, "idx", k)))``
joined with ``/`` (a NamedTuple field keeps JAX's leading dot:
``.params/seg0/k0/attn/wq``), with ``/`` spelt ``__`` inside the npz.  A
bfloat16 leaf is stored as float32 and marked ``{"dtype": "bfloat16"}`` in
the manifest; every other leaf records its numpy dtype name.  Both casts are
torch's, so no bfloat16 numpy type is needed.

``restore`` places leaves on any mesh through target shardings
(``parallel.sharding.NamedSharding``): a run checkpointed on one layout
restarts on another, since the mesh is an argument, not a property of the
checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from ..tree_util import leaves_with_path, map_with_path

_SEP = "/"


def _key(path) -> str:
    return _SEP.join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _flatten(tree) -> dict:
    """``{key: leaf}`` in the tree's flattening order."""
    return {_key(path): leaf for path, leaf in leaves_with_path(tree)}


def _host_copy(leaf, devices: set):
    """A copy of ``leaf`` in host memory that nothing else holds: a later
    in-place update of the leaf (the train step's) cannot reach it.  A copy
    from the card goes into pinned memory asynchronously, and its device
    joins ``devices``, for the caller to synchronize."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if not t.is_cuda:
            return t.clone()
        devices.add(t.device)
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)
    return np.array(leaf, copy=True)


def _to_numpy(leaf) -> tuple:
    """(numpy array, manifest dtype name) of a leaf, bfloat16 as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.astype(np.float32), "bfloat16"
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, *, keep_last: int = 3) -> str:
    """Blocking atomic save.  Returns the checkpoint path."""
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "time": time.time(), "leaves": {}}
    for key, leaf in flat.items():
        arr, dtype = _to_numpy(leaf)
        manifest["leaves"][key] = {"dtype": dtype}
        arrays[key.replace(_SEP, "__")] = arr
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (one in flight at a time).

    ``save`` copies every leaf to host memory on the calling thread before the
    writer thread starts (the train step updates its tensors in place, so the
    writer must not read them); ``copy=False`` hands over a tree whose leaves
    are already such private host copies.  A write that raised raises again
    from the next ``wait`` (or ``save``).  ``write_s`` holds each finished
    write's seconds on the writer thread."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self.write_s: list = []
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree, *, copy: bool = True):
        self.wait()
        host_tree = tree
        if copy:
            devices: set = set()
            host_tree = map_with_path(lambda _, x: _host_copy(x, devices), tree)
            for device in devices:
                torch.cuda.current_stream(device).synchronize()
        self._thread = threading.Thread(target=self._write, args=(step, host_tree), daemon=True)
        self._thread.start()

    def _write(self, step: int, tree) -> None:
        t0 = time.perf_counter()
        try:
            save(self.ckpt_dir, step, tree, keep_last=self.keep_last)
        except BaseException as e:  # handed to the training thread by wait()
            self._error = e
            return
        self.write_s.append(time.perf_counter() - t0)

    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, *, step: int | None = None, shardings=None):
    """Restore into the structure of ``template``: ``(tree, step)``, each leaf
    a new tensor on its template leaf's device (the CPU for a leaf that is
    not a tensor); the template is left as it was.

    ``shardings``: optional tree of ``NamedSharding``s of the same structure;
    such a leaf becomes a ``DTensor`` on that sharding's mesh, each rank
    building its own shard from the host array, with no collective (elastic
    reshard-on-load)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    from ..parallel.sharding import device_put

    flat_s = _flatten(shardings) if shardings is not None else {}
    with np.load(os.path.join(path, "arrays.npz")) as arrays:

        def load(p, tmpl):
            key = _key(p)
            arr = arrays[key.replace(_SEP, "__")]
            dtype = manifest["leaves"][key]["dtype"]
            if dtype == "bfloat16":
                t = torch.from_numpy(arr).to(torch.bfloat16)
            else:
                t = torch.from_numpy(arr.astype(dtype, copy=False))
            if key in flat_s:
                return device_put(t, flat_s[key])
            return t.to(tmpl.device) if isinstance(tmpl, torch.Tensor) else t

        return map_with_path(load, template), step


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
