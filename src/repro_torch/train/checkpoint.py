"""Manifest-driven checkpointing with atomic commit and async write
(``repro.train.checkpoint`` in torch), in the reference's on-disk format.

Layout:
  <dir>/step_00000123.tmp/...   (written)
  <dir>/step_00000123/          (atomic rename on success)
      manifest.json           leaf paths, shapes, dtypes, step, extra,
                              config fingerprint
      leaf_00000.npy ...      one file per leaf

Leaf paths are ``jax.tree_util.keystr`` strings of the tree
(``['params']['blocks'][0]['attn']['wq']``, ``['opt'].step``; see
``core.tree``) and bf16 leaves are stored as ``uint16`` with logical
dtype ``"bfloat16"``, so a checkpoint written by either package restores
in the other, bit for bit.

Failure atomicity: a crash mid-write leaves only a ``.tmp`` dir, which
``latest_step`` ignores and ``clean_tmp`` removes.  Recovery restores the
last committed checkpoint and replays the step-indexed data stream from
that step.

Sharded trees (DTensor leaves, the sharded train step's): a save gathers
each leaf whole with ``full_tensor()``, every rank of its mesh taking
part on the calling thread, and rank 0 of the process group alone
writes, in the same format.  ``restore(..., shardings=)`` re-shards on
load: every rank reads each leaf whole and keeps its own shard of the
placements given, on any mesh (the elastic recovery's smaller one) or
none.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..core.distributed import resolve_device
from ..core.tree import tree_leaves, tree_map, tree_paths, tree_unflatten


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of the process
    group, or the one process when none is up."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _host_copy(tree):
    """The tree's tensors copied to the host (a DTensor gathered whole
    first: a collective), so later writes to its tensors do not reach
    the checkpoint."""
    def copy(x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return x
    return tree_map(copy, tree)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array; a bf16 tensor as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _logical_dtype(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None,
         fingerprint: str = "") -> str:
    """Synchronous atomic save.  Returns the committed directory.  Every
    rank calls it for a tree with DTensor leaves; rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if any(isinstance(x, DTensor) for _, x in tree_paths(tree)):
        tree = _host_copy(tree)
    if not _writes():
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "step": int(step),
        "fingerprint": fingerprint,
        "extra": extra or {},
        "leaves": [],
    }
    for i, (path, leaf) in enumerate(tree_paths(tree)):
        arr = _host_array(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": path, "file": fname, "shape": list(arr.shape),
             "dtype": _logical_dtype(leaf, arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, name,
                                                "manifest.json")):
            steps.append(int(name[5:]))
    return max(steps) if steps else None


def clean_tmp(ckpt_dir: str) -> int:
    """Remove crash leftovers; returns count removed."""
    n = 0
    if not os.path.isdir(ckpt_dir):
        return 0
    for name in os.listdir(ckpt_dir):
        if name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name))
            n += 1
    return n


def _tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    """A stored leaf as a CPU tensor: raw ``uint16`` bits of a bfloat16
    leaf viewed back, without ``ml_dtypes``."""
    if arr.dtype.kind == "u" and str(arr.dtype) != logical:
        if logical != "bfloat16":
            raise ValueError(f"cannot read a leaf stored as {arr.dtype} "
                             f"with logical dtype {logical}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like_tree, device="cuda",
            fingerprint: Optional[str] = None, shardings=None):
    """Restore into the structure of ``like_tree`` (tensors, ``meta`` ones
    included), each leaf in its like's dtype on ``device`` (the card
    unless the caller asks for the CPU).  ``shardings``: a matching tree
    of ``sharding.MeshSharding`` for elastic re-shard-on-load, each leaf
    then a DTensor on its mesh's device (every rank of the mesh calls
    it).  Returns (tree, manifest)."""
    sh_flat = (tree_leaves(shardings) if shardings is not None
               else [None] * len(tree_paths(like_tree)))
    if shardings is not None:
        device = _mesh_device(sh_flat[0].mesh)
    dev = resolve_device(device)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    if fingerprint is not None and manifest["fingerprint"] != fingerprint:
        raise ValueError(
            f"checkpoint fingerprint {manifest['fingerprint']!r} != expected "
            f"{fingerprint!r} — refusing to restore a different config")
    by_path = {l["path"]: l for l in manifest["leaves"]}
    out = []
    for (path, like), sh in zip(tree_paths(like_tree), sh_flat,
                                strict=True):
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = np.load(os.path.join(final, entry["file"]))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"{path}: shape {arr.shape} != expected {tuple(like.shape)}")
        t = _tensor(arr, entry["dtype"]).to(device=dev, dtype=like.dtype)
        out.append(t if sh is None else sh.place(t))
    return tree_unflatten(like_tree, out), manifest


def _mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` holds its shards on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class AsyncCheckpointer:
    """Background writer thread: ``submit`` returns once the tree is copied
    to the host; commits happen in order.  ``wait()`` drains the queue.
    Under a process group every rank submits (a DTensor tree is gathered
    on the calling thread) and rank 0 alone queues the write."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra, fingerprint = item
            try:
                save(self.ckpt_dir, step, host_tree, extra, fingerprint)
                self._gc()
            except BaseException as e:  # surfaced on wait()
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir,
                                       f"step_{s:08d}"), ignore_errors=True)

    def submit(self, step: int, tree, extra=None, fingerprint: str = ""):
        # the host copy on the caller thread: later in-place writes to the
        # tree's tensors do not reach the checkpoint
        host_tree = _host_copy(tree)
        if _writes():
            self._q.put((int(step), host_tree, extra, fingerprint))

    def wait(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        self.wait()
        self._q.put(None)
        self._t.join()
