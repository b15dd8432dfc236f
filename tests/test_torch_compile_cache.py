"""The on-disk compile cache (``repro_torch.core.compile_cache``) on the CPU.

The cache's artifact is the compiled CUDA library; here a file of random
bytes stands in for it.  The eager lowerings (and ``cuda`` over CPU
tensors, its plain versions) have nothing compiled to keep: they store
no record, and their results are the same with the cache on and off.
The round trip through a real library runs on the card
(``tests/test_torch_serve_gpu.py``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import carry
from repro_torch.core import _native, api, compile_cache, cuda_suite
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import UnsupportedKernel

ROOT = Path(__file__).resolve().parents[1]

#: a launch specialization's key components (the argument order of
#: artifact_key), and one change of each
BASE = dict(fingerprint="f" * 64, backend="cuda", grid=Dim3(4),
            block=Dim3(64), grain=1, dyn_shared=None, interpret=True,
            names=("a", "b"),
            shapes=(((256,), torch.float32, torch.device("cpu")),
                    ((256,), torch.int32, torch.device("cpu"))),
            devices=None, shard_axis="blocks", donate_idx=())
CHANGES = {
    "fingerprint": "e" * 64,
    "backend": "vector",
    "grid": Dim3(8),
    "block": Dim3(32, 2),
    "grain": 2,
    "dyn_shared": 64,
    "interpret": False,
    "names": ("a", "c"),
    "shape": (((512,), torch.float32, torch.device("cpu")),
              ((256,), torch.int32, torch.device("cpu"))),
    "dtype": (((256,), torch.float64, torch.device("cpu")),
              ((256,), torch.int32, torch.device("cpu"))),
    "devices": 2,
    "shard_axis": "x",
    "donate_idx": (1,),
}


def _key(**over):
    kw = {**BASE, **over}
    return compile_cache.artifact_key(
        kw["fingerprint"], kw["backend"], kw["grid"], kw["block"],
        kw["grain"], kw["dyn_shared"], kw["interpret"], kw["names"],
        kw["shapes"], devices=kw["devices"], shard_axis=kw["shard_axis"],
        donate_idx=kw["donate_idx"])


def test_key_is_a_sha256_and_stable_in_a_subprocess():
    key = _key()
    assert len(key) == 64 and int(key, 16) >= 0
    assert _key() == key
    code = ("import sys, torch\n"
            "sys.path.insert(0, 'tests')\n"
            "from test_torch_compile_cache import _key\n"
            "print(_key())\n")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == key


@pytest.mark.parametrize("part", sorted(CHANGES))
def test_key_changes_with_each_launch_component(part):
    name = {"shape": "shapes", "dtype": "shapes"}.get(part, part)
    assert _key(**{name: CHANGES[part]}) != _key()


@pytest.mark.parametrize("part", ["format", "torch", "cuda", "sources",
                                  "device_count", "device"])
def test_key_changes_with_the_platform_and_the_sources(monkeypatch, part):
    before = _key()
    if part == "format":
        monkeypatch.setattr(compile_cache, "CACHE_FORMAT_VERSION", 2)
    elif part == "torch":
        monkeypatch.setattr(torch, "__version__", "0.0.0")
    elif part == "cuda":
        monkeypatch.setattr(torch.version, "cuda", "0.0")
    elif part == "sources":
        monkeypatch.setattr(_native, "source_hash", lambda: "0" * 16)
    elif part == "device_count":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    else:
        # the same leaves on a card: its name and capability join the key
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda dev: "NVIDIA H100 80GB HBM3")
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda dev: (9, 0))
        card = tuple((s, d, torch.device("cuda", 0))
                     for s, d, _ in BASE["shapes"])
        assert _key(shapes=card) != before
        return
    assert _key() != before


@pytest.fixture
def fake_library(tmp_path):
    """A file that stands in for the compiled library."""
    lib = tmp_path / "build" / "libcupbop_0123456789abcdef.so"
    lib.parent.mkdir()
    lib.write_bytes(np.random.default_rng(0).bytes(4096))
    return lib


def test_store_load_and_prune(tmp_path, fake_library):
    cache = compile_cache.DiskCache(str(tmp_path / "cache"))
    assert cache.load("k" * 64) is None            # nothing stored yet
    assert cache.store("k" * 64, fake_library, fingerprint="fp",
                       backend="cuda")
    files = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert files == sorted([f"{'k' * 64}.bin", fake_library.name])
    assert (tmp_path / "cache" / fake_library.name).read_bytes() == \
        fake_library.read_bytes()
    rec = cache.load("k" * 64)
    assert rec["library"] == fake_library.name
    assert rec["fingerprint"] == "fp" and rec["backend"] == "cuda"
    assert rec["format"] == compile_cache.CACHE_FORMAT_VERSION
    # a second specialization shares the one copy of the library
    assert cache.store("j" * 64, fake_library, fingerprint="fp2",
                       backend="cuda")
    assert len(list((tmp_path / "cache").glob("*.so"))) == 1
    assert cache.library(fake_library.name) == \
        tmp_path / "cache" / fake_library.name
    assert cache.prune() == 3
    assert list((tmp_path / "cache").iterdir()) == []
    assert cache.load("k" * 64) is None
    assert compile_cache.DiskCache(str(tmp_path / "nowhere")).prune() == 0


def test_store_of_nothing_compiled_writes_nothing(tmp_path):
    cache = compile_cache.DiskCache(str(tmp_path / "cache"))
    assert not cache.store("k" * 64, None, fingerprint="fp",
                           backend="vector")
    assert not (tmp_path / "cache").exists()


def test_writes_are_atomic_and_leave_no_tmp(tmp_path, fake_library,
                                             monkeypatch):
    cache = compile_cache.DiskCache(str(tmp_path / "cache"))
    assert cache.store("k" * 64, fake_library, fingerprint="fp",
                       backend="cuda")
    assert not list((tmp_path / "cache").glob("*.tmp"))
    # a write that fails before its rename leaves the old record whole
    # and no temporary file behind; the store reports False
    old = (tmp_path / "cache" / f"{'k' * 64}.bin").read_bytes()

    def refuse(src, dst):
        raise OSError("disk full")
    monkeypatch.setattr(compile_cache.os, "replace", refuse)
    assert not cache.store("k" * 64, fake_library, fingerprint="other",
                           backend="cuda")
    assert not list((tmp_path / "cache").glob("*.tmp"))
    assert (tmp_path / "cache" / f"{'k' * 64}.bin").read_bytes() == old


@pytest.mark.parametrize("damage", ["garbage", "not_a_dict", "missing_key",
                                    "other_format", "foreign_library"])
def test_a_corrupt_record_is_deleted(tmp_path, fake_library, damage):
    cache = compile_cache.DiskCache(str(tmp_path / "cache"))
    assert cache.store("k" * 64, fake_library, fingerprint="fp",
                       backend="cuda")
    rec_file = tmp_path / "cache" / f"{'k' * 64}.bin"
    rec = json.loads(rec_file.read_bytes())
    if damage == "garbage":
        rec_file.write_bytes(b"\x00\xffnot json")
    elif damage == "not_a_dict":
        rec_file.write_text("[1, 2]")
    elif damage == "missing_key":
        del rec["sha256"]
        rec_file.write_text(json.dumps(rec))
    elif damage == "other_format":
        rec["format"] = compile_cache.CACHE_FORMAT_VERSION + 1
        rec_file.write_text(json.dumps(rec))
    else:
        rec["library"] = "../build/" + fake_library.name
        rec_file.write_text(json.dumps(rec))
    assert cache.load("k" * 64) is None
    assert not rec_file.exists()
    assert fake_library.exists()                 # nothing outside is touched


def test_a_library_with_the_wrong_hash_is_deleted(tmp_path, fake_library):
    cache = compile_cache.DiskCache(str(tmp_path / "cache"))
    assert cache.store("k" * 64, fake_library, fingerprint="fp",
                       backend="cuda")
    cached = tmp_path / "cache" / fake_library.name
    cached.write_bytes(b"truncated")
    assert cache.load("k" * 64) is None
    assert not cached.exists()
    assert not (tmp_path / "cache" / f"{'k' * 64}.bin").exists()
    # the next store copies the library in again
    assert cache.store("k" * 64, fake_library, fingerprint="fp",
                       backend="cuda")
    assert cache.load("k" * 64) is not None


def test_a_record_whose_library_is_gone_is_deleted(tmp_path, fake_library):
    cache = compile_cache.DiskCache(str(tmp_path / "cache"))
    assert cache.store("k" * 64, fake_library, fingerprint="fp",
                       backend="cuda")
    (tmp_path / "cache" / fake_library.name).unlink()
    assert cache.load("k" * 64) is None
    assert not (tmp_path / "cache" / f"{'k' * 64}.bin").exists()


@pytest.mark.parametrize("value", ["", "off", "OFF", "0", "none", "None"])
def test_from_env_off_values_disable_the_cache(monkeypatch, value):
    monkeypatch.setenv("CUPBOP_CACHE_DIR", value)
    assert compile_cache.from_env() is None


def test_from_env_unset_disables_and_a_path_enables(monkeypatch, tmp_path):
    monkeypatch.delenv("CUPBOP_CACHE_DIR", raising=False)
    assert compile_cache.from_env() is None
    monkeypatch.setenv("CUPBOP_CACHE_DIR", str(tmp_path / "c"))
    cache = compile_cache.from_env()
    assert cache.path == str(tmp_path / "c")


ENTRIES = ("vecadd", "reverse", "histogram", "scan_block")


@pytest.mark.parametrize("backend", ["loop", "vector", "naive",
                                     "loop_nowarp", "cuda"])
def test_eager_launches_store_nothing_and_keep_their_bits(tmp_path,
                                                          backend):
    """The eager lowerings (and ``cuda``'s plain versions over CPU
    tensors) have nothing compiled: no record, no hit that saves
    nothing, the same bits as with the cache off."""
    entries = [e for e in cuda_suite.build_suite(1) if e.name in ENTRIES]
    runs = {}
    for on in (False, True):
        api.cache_clear()
        if on:
            api.enable_disk_cache(str(tmp_path))
        try:
            outs = []
            for e in entries:
                args = carry.from_reference(
                    e.make_args(np.random.default_rng(0)), device="cpu")
                try:
                    outs.append(api.launch(
                        e.kernel, grid=e.grid, block=e.block, args=args,
                        dyn_shared=e.dyn_shared, backend=backend))
                except UnsupportedKernel:
                    outs.append(None)        # a Table-II unsupport cell
            stats = api.cache_stats()
        finally:
            api.disable_disk_cache()
        runs[on] = outs, stats
    (off, _), (on, stats) = runs[False], runs[True]
    assert stats.disk_stores == 0 and stats.disk_hits == 0
    assert stats.misses == len(entries)
    assert list(tmp_path.iterdir()) == []
    for a, b in zip(off, on):
        assert (a is None) == (b is None)
        for k in (a or {}):
            assert torch.equal(a[k], b[k])
    api.cache_clear()


def test_a_launch_on_cpu_tensors_never_builds_the_library(tmp_path,
                                                          monkeypatch):
    def no_build():
        raise AssertionError("the library was asked for")
    monkeypatch.setattr(_native, "library", no_build)
    api.cache_clear()
    api.enable_disk_cache(str(tmp_path))
    try:
        e = cuda_suite.entry_vecadd()
        args = carry.from_reference(e.make_args(np.random.default_rng(0)),
                                    device="cpu")
        out = api.launch(e.kernel, grid=e.grid, block=e.block, args=args,
                         backend="cuda")
        assert api.cache_stats().disk_stores == 0
        np.testing.assert_array_equal(out["c"].numpy(),
                                      (args["a"] + args["b"]).numpy())
    finally:
        api.disable_disk_cache()
        api.cache_clear()


def test_build_takes_the_library_from_the_cache_before_nvcc(tmp_path,
                                                            monkeypatch):
    """A process whose build directory is empty and whose cache holds the
    library runs no nvcc and spends no build time."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    name = f"libcupbop_{_native.source_hash()}.so"

    def no_nvcc():
        raise AssertionError("nvcc ran")
    monkeypatch.setattr(_native, "_nvcc", no_nvcc)
    api.enable_disk_cache(str(tmp_path / "cache"))
    try:
        (tmp_path / "cache").mkdir()
        (tmp_path / "cache" / name).write_bytes(b"stands in for the .so")
        path, seconds, log = _native.build()
        assert path == tmp_path / "cache" / name
        assert seconds == 0.0 and log == ""
        # an up-to-date build in BUILD_DIR comes first
        (tmp_path / "build").mkdir()
        (tmp_path / "build" / name).write_bytes(b"built here")
        assert _native.build()[0] == tmp_path / "build" / name
    finally:
        api.disable_disk_cache()
    # with the cache off, an empty build directory means nvcc
    (tmp_path / "build" / name).unlink()
    with pytest.raises(AssertionError, match="nvcc ran"):
        _native.build()


def test_cupbop_cache_dir_is_honoured_not_refused(tmp_path):
    code = (
        "import numpy as np\n"
        "from repro_torch import carry\n"
        "from repro_torch.core import api, cuda_suite\n"
        "e = cuda_suite.entry_vecadd()\n"
        "args = carry.from_reference(e.make_args(np.random.default_rng(0)),\n"
        "                            device='cpu')\n"
        "out = e.kernel[e.grid, e.block](args)\n"
        "api.launch(e.kernel, grid=e.grid, block=e.block, args=args,\n"
        "           backend='cuda')\n"
        "print(api._DISK.path, api.cache_stats().disk_stores)\n")
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}",
           "CUPBOP_CACHE_DIR": str(tmp_path / "c")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [str(tmp_path / "c"), "0"]


def test_enable_and_disable_disk_cache():
    try:
        cache = api.enable_disk_cache("~/some/dir")
        assert isinstance(cache, compile_cache.DiskCache)
        assert api._DISK is cache
        assert cache.path == os.path.expanduser("~/some/dir")
    finally:
        api.disable_disk_cache()
    assert api._DISK is None
    assert {"disk_hits", "disk_stores"} <= set(vars(api.cache_stats()))
