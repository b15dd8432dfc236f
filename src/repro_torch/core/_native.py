"""Build and load the port's hand-written CUDA kernels.

All of ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` (one compiler per source, all started together) into one
shared library with a plain C interface, under ``build/repro_torch/`` at
the root of the checkout, and loaded with ``ctypes``.  The file name
carries a hash of the sources and flags, so a stale build is never
loaded.  The build happens at first use, inside the first launch on the
card; importing this module builds nothing.

With the on-disk compile cache enabled (:mod:`repro_torch.core
.compile_cache`), a library missing from ``BUILD_DIR`` is looked for in
the cache directory before ``nvcc`` runs: a new process over a warm
cache compiles nothing.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")   # when not on PATH
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")


@dataclasses.dataclass
class NativeLibrary:
    """The loaded library, where it came from and what building it cost."""

    path: Path
    cdll: ctypes.CDLL
    build_seconds: float      # 0.0 when an up-to-date build was found
    log: str                  # nvcc's output (ptxas register/smem report)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(repr(COMPILE_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if TOOLKIT_NVCC.exists():
        return str(TOOLKIT_NVCC)
    raise RuntimeError("nvcc not found: the cuda backend's kernels are "
                       "built from source on a machine with the CUDA "
                       "toolkit")


def _disk_cache():
    """The on-disk compile cache, when it is enabled (api imports this
    module, so it is looked up at call time)."""
    from repro_torch.core import api
    return api._DISK


def build() -> tuple[Path, float, str]:
    """Compile the sources unless an up-to-date library exists, in
    ``BUILD_DIR`` or in the enabled disk cache's directory.

    One ``nvcc -c`` per source, all started together, then one link.
    Returns ``(path, seconds spent, nvcc output)``; raises on failure.
    """
    tag = source_hash()
    out = BUILD_DIR / f"libcupbop_{tag}.so"
    if out.exists():
        return out, 0.0, ""
    disk = _disk_cache()
    cached = None if disk is None else disk.library(out.name)
    if cached is not None:
        return cached, 0.0, ""
    nvcc = _nvcc()
    objdir = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = objdir / f"{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], []
    for obj, proc in jobs:          # wait for every compiler we started
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(obj.stem)
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = objdir / out.name
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *(str(obj) for obj, _ in jobs)],
                          capture_output=True, text=True, check=False)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                           f"{link.stderr}")
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
    return out, time.perf_counter() - t0, log + link.stdout + link.stderr


@functools.cache
def library() -> NativeLibrary:
    """Build (if needed) and load the kernels' library, once per process."""
    path, seconds, log = build()
    return NativeLibrary(path, ctypes.CDLL(str(path)), seconds, log)


@functools.cache
def function(symbol: str, argtypes: tuple):
    """The C launcher ``symbol`` with its argument types declared.

    Launchers return the ``cudaError_t`` of their launch as an int.
    """
    fn = getattr(library().cdll, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(symbol: str, argtypes: tuple, cargs: list, device) -> None:
    """Call the C launcher ``symbol`` with ``cargs`` and the current
    stream of ``device`` (its last argument); raises unless the launch's
    ``cudaError_t`` is 0."""
    fn = function(symbol, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*cargs, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}: launch failed with cudaError_t {rc}")
