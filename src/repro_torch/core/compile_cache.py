"""Persistent compile cache: the compiled CUDA module on disk.

CuPBoP ships kernels as cubin/fatbinary files that ``cudaModuleLoad``
maps into a process without recompiling (Fig. 3's driver-library
replacement).  On Hopper the port's compiled module is literally that:
the shared library that ``nvcc`` builds from ``src/repro_torch/csrc/``
(:mod:`repro_torch.core._native`), 25-35 s of compiling on the machine
with the card.  This module keeps it on disk, so a *new process* loads
it instead of compiling.

Layout, under the cache directory:

* one ``libcupbop_<source hash>.so``, shared by every specialization
  (its name carries the hash of the sources and flags that built it);
* one ``<key>.bin`` per launch specialization: a small record naming the
  library, the sha256 of its bytes, and the kernel's fingerprint and
  backend.

The key is a sha256 over the cache format, the torch and CUDA versions,
the launch's device (name and capability, or ``cpu``), the device count,
the kernel sources' hash, the kernel fingerprint and backend, the launch
geometry and options and the buffers' names, shapes and dtypes - so a
directory shared between a CPU process and a GPU process, or kept across
a source edit, never serves the wrong artifact (stale records are simply
orphaned; :meth:`DiskCache.prune` deletes everything).

Only a launch of hand-written kernels on the card has something compiled
to keep.  The ``loop``, ``vector``, ``naive`` and ``loop_nowarp``
lowerings run eagerly, and so does a ``cuda`` launch over CPU tensors
(the plain versions): for them :meth:`DiskCache.store` writes nothing and
returns ``False``, as the reference's does for a lowering ``jax.export``
cannot take.  A record never counts a hit that saves nothing.

The directory comes from ``CUPBOP_CACHE_DIR`` (``off``/``0``/``none``/
empty disable it) or :func:`repro_torch.core.api.enable_disk_cache`;
there is no default directory.  The cache is best-effort: a corrupt
record, a library whose bytes do not match its record, or an unwritable
directory degrades to in-memory caching, never to an error.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from pathlib import Path

import torch

from repro_torch.core import _native

CACHE_FORMAT_VERSION = 1


def _platform(shapes) -> tuple:
    """What the artifact was built for: torch and CUDA versions, the
    launch's device (the card's name and capability, or ``cpu``) and the
    process's device count."""
    cards = sorted({str(dev) for *_, dev in shapes
                    if torch.device(dev).type == "cuda"})
    if cards:
        dev = torch.device(cards[0])
        device = (torch.cuda.get_device_name(dev),
                  torch.cuda.get_device_capability(dev))
    else:
        device = "cpu"
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return torch.__version__, torch.version.cuda, device, count


def artifact_key(fingerprint: str, backend: str, grid, block, grain,
                 dyn_shared, interpret, names, shapes, *,
                 devices=None, shard_axis: str = "blocks",
                 donate_idx: tuple[int, ...] = ()) -> str:
    """Stable cross-process hash of one launch specialization.

    ``shapes`` holds each leaf's ``(shape, dtype, device)``; the device
    decides the platform part of the key, so a CPU process and a GPU
    process sharing a directory never serve each other's artifacts.
    """
    payload = repr((CACHE_FORMAT_VERSION, *_platform(shapes),
                    _native.source_hash(), fingerprint, backend,
                    tuple(grid), tuple(block), grain, dyn_shared, interpret,
                    devices, shard_axis, tuple(donate_idx), tuple(names),
                    tuple((tuple(s), str(d)) for s, d, *_ in shapes)))
    return hashlib.sha256(payload.encode()).hexdigest()


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class DiskCache:
    """A directory of launch records over one compiled library
    (best-effort, atomic writes)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(os.path.expanduser(path))
        # sha256 of a library's bytes, by (path, size, mtime)
        self._digests: dict[tuple, str] = {}

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.bin")

    def library(self, name: str) -> Path | None:
        """The cached library called ``name``, if the directory holds it."""
        path = Path(self.path) / name
        return path if path.is_file() else None

    def _digest(self, path: str) -> str:
        st = os.stat(path)
        key = (path, st.st_size, st.st_mtime_ns)
        if key not in self._digests:
            h = hashlib.sha256()
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            self._digests[key] = h.hexdigest()
        return self._digests[key]

    def _write(self, dst: str, fill) -> None:
        """Write ``dst`` through a temporary file and ``os.replace``:
        concurrent readers see the old file or the whole new one."""
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                fill(f)
            os.replace(tmp, dst)
        except BaseException:
            _unlink(tmp)
            raise

    def load(self, key: str) -> dict | None:
        """The record for ``key``, or None.

        A record is served only while the library it names is in the
        directory and its bytes hash to the record's value.  A corrupt
        record is deleted; so are a record whose library is missing and a
        library whose bytes do not match (it would be loaded next).
        """
        try:
            with open(self._file(key), "rb") as f:
                rec = json.loads(f.read())
            lib = os.path.join(self.path, rec["library"])
            want = rec["sha256"]
            if rec["format"] != CACHE_FORMAT_VERSION or \
                    os.path.dirname(lib) != self.path:
                raise ValueError("foreign record")
        except FileNotFoundError:
            return None
        except (OSError, ValueError, KeyError, TypeError):
            _unlink(self._file(key))
            return None
        try:
            ok = self._digest(lib) == want
        except OSError:               # the library is gone
            ok = None
        if not ok:
            _unlink(self._file(key))
            if ok is False:
                _unlink(lib)
            return None
        return rec

    def store(self, key: str, library: Path | None, *, fingerprint: str,
              backend: str) -> bool:
        """Persist the record for ``key`` over ``library``, the compiled
        module the launch runs; copy the library in if the directory does
        not hold it yet.

        ``library`` is None for a launch with nothing compiled (an eager
        lowering, or plain versions over CPU tensors): nothing is written
        and the result is False.  Any failure (an unwritable directory)
        is swallowed - the in-memory cache still holds the entry.
        """
        if library is None:
            return False
        try:
            os.makedirs(self.path, exist_ok=True)
            dst = os.path.join(self.path, Path(library).name)
            if not os.path.isfile(dst):
                with open(library, "rb") as src:
                    self._write(dst, lambda f: shutil.copyfileobj(src, f))
            rec = {"format": CACHE_FORMAT_VERSION,
                   "library": os.path.basename(dst),
                   "sha256": self._digest(dst),
                   "fingerprint": fingerprint, "backend": backend}
            blob = json.dumps(rec, sort_keys=True).encode()
            self._write(self._file(key), lambda f: f.write(blob))
            return True
        except OSError:
            return False

    def prune(self) -> int:
        """Delete every record and library; returns the number removed."""
        n = 0
        try:
            names = os.listdir(self.path)
        except OSError:
            return 0
        for name in names:
            if name.endswith((".bin", ".tmp")) or (
                    name.startswith("libcupbop_") and name.endswith(".so")):
                try:
                    os.unlink(os.path.join(self.path, name))
                    n += 1
                except OSError:
                    pass
        return n


def from_env() -> "DiskCache | None":
    """The process-default DiskCache from ``CUPBOP_CACHE_DIR``."""
    path = os.environ.get("CUPBOP_CACHE_DIR", "")
    if not path or path.lower() in ("off", "0", "none"):
        return None
    return DiskCache(path)
