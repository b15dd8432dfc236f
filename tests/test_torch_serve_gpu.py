"""The serving tier's batch entry and the disk cache on the card.

Every test here is marked ``gpu`` and skips without a CUDA device; on a
machine with one they run with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_serve_gpu.py``.  The file imports neither JAX nor the
reference package.  On the card a ``cuda`` batch entry launches the
hand-written kernel once a row, back to back on the current stream: its
rows must be bit for bit the independent launches they replace, on the
call that builds the entry and on every later one.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import carry
from repro_torch.core import _native, api, cuda_suite, lower_cuda
from repro_torch.serve import KernelService
from repro_torch.serve.kernel_service import _bucket

ROOT = Path(__file__).resolve().parents[1]
SINGLE = [e.name for e in cuda_suite.build_suite(1) if e.chain is None]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _entry(name):
    return next(e for e in cuda_suite.build_suite(1) if e.name == name)


def _rows(entry, n, card, seed=0):
    rng = np.random.default_rng(seed)
    return [carry.from_reference(entry.make_args(rng), const=entry.const,
                                 device=card) for _ in range(n)]


def _launches(entry) -> int:
    return lower_cuda.kernel_for(entry.kernel).launches


def _singles(entry, rows):
    return [api.launch(entry.kernel, grid=entry.grid, block=entry.block,
                       args=a, dyn_shared=entry.dyn_shared, backend="cuda")
            for a in rows]


def _equal(entry, got, want):
    return all(torch.equal(g[k], w[k]) for g, w in zip(got, want)
               for k in entry.kernel.writes)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("name", SINGLE)
def test_cuda_batch_rows_are_their_singles(card, name, n):
    """n rows, padded to the service's power-of-two bucket as it pads
    them (3 -> 4), on the call that builds the entry and on a warm one."""
    entry = _entry(name)
    rows = _rows(entry, n, card)
    want = _singles(entry, rows)
    width = _bucket(n, 8)
    args_list = rows + [rows[-1]] * (width - n)
    api.cache_clear()
    for call in ("cold", "warm"):
        before = _launches(entry)
        got = api.launch_batch(entry.kernel, grid=entry.grid,
                               block=entry.block, args_list=args_list,
                               dyn_shared=entry.dyn_shared, backend="cuda")
        torch.cuda.synchronize()
        assert _launches(entry) - before == width, call
        assert _equal(entry, got[:n], want), (name, n, call)
    s = api.cache_stats()
    assert (s.misses, s.hits) == (1, 1)
    api.cache_clear()


@pytest.mark.gpu
def test_a_later_batch_leaves_the_earlier_results_unchanged(card):
    entry = _entry("stencil1d")
    first, second = _rows(entry, 4, card, 1), _rows(entry, 4, card, 2)
    api.cache_clear()
    kw = dict(grid=entry.grid, block=entry.block, backend="cuda",
              dyn_shared=entry.dyn_shared)
    out1 = api.launch_batch(entry.kernel, args_list=first, **kw)
    held = [{k: v.clone() for k, v in o.items()} for o in out1]
    out2 = api.launch_batch(entry.kernel, args_list=second, **kw)
    out3 = api.launch_batch(entry.kernel, args_list=second, **kw)
    torch.cuda.synchronize()
    assert _equal(entry, out1, held)            # not views of the entry's
    assert _equal(entry, out2, _singles(entry, second))
    assert _equal(entry, out3, out2)
    assert not _equal(entry, out1, out2)
    # the results are the caller's to keep: no two share storage
    ptrs = {o["y"].data_ptr() for o in out1 + out2 + out3}
    assert len(ptrs) == 12
    api.cache_clear()


@pytest.mark.gpu
def test_the_worker_dispatches_while_another_thread_copies(card):
    """The service's worker builds and runs its batch entries (on device
    0's default stream, in its own thread) while a caller thread keeps
    copying inputs to the card."""
    entries = [_entry(n) for n in ("vecadd", "histogram", "softmax_row")]
    host = {e.name: [e.make_args(np.random.default_rng(i))
                     for i in range(8)] for e in entries}
    stop = threading.Event()
    copied = []

    def copier():
        rng = np.random.default_rng(9)
        while not stop.is_set():
            x = rng.standard_normal(1 << 20, dtype=np.float32)
            copied.append(torch.from_numpy(x).to(card).sum().item())

    api.cache_clear()
    svc = KernelService(backend="cuda", max_batch=8, autostart=False,
                        max_queue=64, device=card)
    thread = threading.Thread(target=copier)
    try:
        for e in entries:
            svc.register_entry(e)
        tickets = [(e, a, svc.submit(e.name, carry.from_reference(
            a, device=card))) for e in entries for a in host[e.name]]
        thread.start()
        svc.start()
        results = [(e, a, t.result(timeout=300)) for e, a, t in tickets]
    finally:
        stop.set()
        thread.join(timeout=60)
        svc.close()
    assert not thread.is_alive() and copied
    st = svc.stats()
    assert st.failed == 0 and st.batched_requests == 24
    assert st.batch_occupancy == {8: 3}
    for e, a, got in results:
        want = _singles(e, [carry.from_reference(a, const=e.const,
                                                 device=card)])[0]
        for k in e.kernel.writes:
            assert torch.equal(got[k], want[k]), (e.name, k)
    api.cache_clear()


@pytest.mark.gpu
def test_the_service_batches_every_request_on_the_card(card):
    ents = [_entry(n) for n in SINGLE]
    api.cache_clear()
    svc = KernelService(backend="cuda", max_batch=8, autostart=False,
                        max_queue=len(ents) * 16, device=card)
    try:
        for e in ents:
            svc.register_entry(e)
        rows = {e.name: _rows(e, 8, card) for e in ents}
        tickets = [(e, i, svc.submit(e.name, rows[e.name][i]))
                   for _ in range(2) for e in ents for i in range(8)]
        before = {e.name: _launches(e) for e in ents}
        svc.start()
        got = [(e, i, t.result(timeout=300)) for e, i, t in tickets]
    finally:
        svc.close()
    st = svc.stats()
    assert st.failed == 0 and st.completed == len(tickets)
    assert st.batched_requests == len(tickets)
    assert st.batch_occupancy == {8: 2 * len(ents)}
    for e in ents:
        assert _launches(e) - before[e.name] == 16, e.name
    want = {e.name: _singles(e, rows[e.name]) for e in ents}
    for e, i, out in got:
        for k in e.kernel.writes:
            assert torch.equal(out[k], want[e.name][i][k]), (e.name, k)
    api.cache_clear()


CHILD = """
import json, sys, tempfile
from pathlib import Path
import numpy as np
from repro_torch import carry
from repro_torch.core import _native, api, cuda_suite

_native.BUILD_DIR = Path(tempfile.mkdtemp())
def no_nvcc():
    raise AssertionError("nvcc ran in the child")
_native._nvcc = no_nvcc
saved = np.load(sys.argv[1])
for e in cuda_suite.build_suite(1):
    if e.name in sys.argv[2:]:
        args = carry.from_reference(e.make_args(np.random.default_rng(0)),
                                    const=e.const, device="cuda")
        out = api.launch(e.kernel, grid=e.grid, block=e.block, args=args,
                         dyn_shared=e.dyn_shared, backend="cuda")
        for k in e.kernel.writes:
            assert np.array_equal(out[k].cpu().numpy(),
                                  saved[f"{e.name}/{k}"]), (e.name, k)
s = api.cache_stats()
lib = _native.library()
print(json.dumps({"disk_hits": s.disk_hits, "misses": s.misses,
                  "disk_stores": s.disk_stores,
                  "build_seconds": lib.build_seconds,
                  "library": str(lib.path)}))
"""


@pytest.mark.gpu
def test_the_disk_cache_serves_a_new_process_without_nvcc(card, tmp_path):
    names = ("vecadd", "reverse", "lud_diag")
    api.cache_clear()
    api.enable_disk_cache(str(tmp_path / "cache"))
    try:
        saved = {}
        for name in names:
            e = _entry(name)
            args = carry.from_reference(
                e.make_args(np.random.default_rng(0)), const=e.const,
                device=card)
            out = api.launch(e.kernel, grid=e.grid, block=e.block,
                             args=args, dyn_shared=e.dyn_shared,
                             backend="cuda")
            saved.update((f"{name}/{k}", out[k].cpu().numpy())
                         for k in e.kernel.writes)
        stores = api.cache_stats().disk_stores
    finally:
        api.disable_disk_cache()
        api.cache_clear()
    assert stores == len(names)
    lib = _native.library().path
    cached = tmp_path / "cache" / lib.name
    assert cached.read_bytes() == lib.read_bytes()
    np.savez(tmp_path / "bits.npz", **saved)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUPBOP_CACHE_DIR": str(tmp_path / "cache")}
    res = subprocess.run([sys.executable, "-c", CHILD,
                          str(tmp_path / "bits.npz"), *names], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr
    child = json.loads(res.stdout.strip().splitlines()[-1])
    assert child["disk_hits"] == stores == child["misses"]
    assert child["disk_stores"] == 0
    assert child["build_seconds"] == 0
    assert child["library"] == str(cached)
