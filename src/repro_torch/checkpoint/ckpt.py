"""Fault-tolerant checkpointing, as ``repro/checkpoint/ckpt.py``: async,
atomic, validated, on torch tensors.

* **async**: the host thread snapshots every leaf to NumPy and hands off
  to a writer thread - the training loop never blocks on disk;
* **atomic**: write to ``step_N.tmp`` then ``os.rename`` - a crash
  mid-write never corrupts the latest checkpoint;
* **validated**: a manifest records per-leaf shape / dtype + SHA-256;
  restore verifies and falls back to the previous checkpoint on mismatch;
* **retention**: keep-last-K with the newest always valid before pruning;
* **data state**: the pipeline step is in the manifest, and the pipeline
  is seekable, so restart resumes the exact token stream.

The layout is the reference's, file for file: a leaf's name joins its
path's keys the way the reference's ``_leaf_paths`` does - a dict key or
a sequence index as itself, a named-tuple field as ``.field`` - so
``(params, opt_state)`` gives ``0_embed_tok``, ``1_.step``,
``1_.m_embed_tok``, ...  and a checkpoint either side wrote restores on
the other.  A bfloat16 leaf is stored as its 16-bit patterns (2-byte
void items, as NumPy saves ``ml_dtypes``' bfloat16) with ``bfloat16`` in
the manifest, so neither side needs ``ml_dtypes``.

Leaves are stored whole: ``save`` gathers a DTensor leaf
(``full_tensor``, a collective every rank joins) and rank 0 writes.
``restore(mesh=)`` reads the whole and shards it onto the mesh it is
given by ``distributed.sharding``'s parameter rules - any mesh, not only
the saver's (the reference's elastic restore).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=()):
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order: dict keys
    sorted, sequences and named tuples in order.  A named-tuple field's
    key is ``.field`` (the reference's ``GetAttrKey`` as a string)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _flatten(x, path + (str(i),))
    else:
        yield path, tree


def _leaf_paths(tree):
    return [("_".join(path), leaf) for path, leaf in _flatten(tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """``(array, manifest dtype)``: a bfloat16 tensor's 16-bit patterns as
    2-byte void items."""
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):          # a DTensor: gather it
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy()
            return bits.view(np.dtype("V2")), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    """The stored array as a tensor of ``like``'s dtype on its device."""
    arr = np.array(arr)         # a C-ordered copy; 0-d stays 0-d
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.saves = 0

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False):
        """Snapshot to host, then write asynchronously.  In a process group
        every rank calls it (DTensor leaves are gathered) and rank 0
        writes; ``blocking`` then waits for every rank."""
        host = [(n, *_to_host(leaf)) for n, leaf in _leaf_paths(tree)]
        if _rank() != 0:
            if blocking:
                _barrier()
            return
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()
            _barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host, extra: dict):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for name, arr, dtype in host:
            fn = f"{name}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][name] = {
                "file": fn, "shape": list(arr.shape), "dtype": dtype,
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self.saves += 1
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def _validate(self, path: str) -> Optional[dict]:
        mf = os.path.join(path, "manifest.json")
        if not os.path.exists(mf):
            return None
        with open(mf) as f:
            manifest = json.load(f)
        for name, meta in manifest["leaves"].items():
            fp = os.path.join(path, meta["file"])
            if not os.path.exists(fp):
                return None
            try:
                arr = np.load(fp)
            except Exception:          # truncated / garbage file
                return None
            if hashlib.sha256(arr.tobytes()).hexdigest() != meta["sha256"]:
                return None
        return manifest

    def latest_valid(self) -> Optional[int]:
        for s in reversed(self.all_steps()):
            if self._validate(os.path.join(self.dir, f"step_{s:08d}")):
                return s
        return None

    def restore(self, template: Any, step: Optional[int] = None,
                mesh=None) -> tuple[Any, dict]:
        """Restore into the structure of ``template``: each leaf a tensor
        of the template leaf's dtype on its device; with ``mesh``, sharded
        onto it by the parameter rules (``sharding.shard_params``)."""
        step = step if step is not None else self.latest_valid()
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        manifest = self._validate(path)
        if manifest is None:
            raise IOError(f"checkpoint {path} failed validation")
        leaves = []
        for name, like in _leaf_paths(template):
            meta = manifest["leaves"][name]
            arr = np.load(os.path.join(path, meta["file"]))
            leaves.append(_from_host(arr, meta["dtype"], like))
        tree = _rebuild(template, iter(leaves))
        if mesh is not None:
            from repro_torch.distributed.sharding import shard_params
            tree = shard_params(tree, mesh)
        return tree, manifest["extra"]
