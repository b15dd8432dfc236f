"""The port's conformance matrix on the CPU (``repro_torch.core.conformance``).

The structure of ``tests/test_conformance.py``, on the port: every case's
base cell passes its oracle on ``vector`` and ``cuda`` (plain versions on
CPU tensors), and on the loop family for the cases that run quickly on
the port's loop lowering; the variant axes (grid refactorizations, the
grain-3 tail, f32/f64/i32 under the port's x64 switch), the replay legs
of the chains, the report, and the gate's self-tests.  ``cuda``'s
refusals of geometries and dtypes its wrappers were not written for are
``unsupport`` cells, named here case by case.  The full variant sweep on
all seven backends runs through the CLI (``python -m
repro_torch.core.conformance --device cpu``), not here; the cross-framework
column against the reference is ``tests/test_torch_conformance_parity.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import conformance  # noqa: E402
from repro_torch.core.backends import (  # noqa: E402
    UnknownBackend,
    backend_names,
    unregister_backend,
)
from repro_torch.core.conformance import (  # noqa: E402
    Cell,
    build_cases,
    grid_variants,
    report_to_json,
    run_cell,
    run_matrix,
)
from repro_torch.core.kernel import UnsupportedKernel  # noqa: E402

CPU = "cpu"
CASES = {c.name: c for c in build_cases()}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: cases whose base cell takes under 0.8 s on the port's loop lowering on
#: the CPU (srad_step and hotspot take 20 s and more; vecadd, scan_block
#: and needle_nw run on loop in tests/test_torch_conformance_parity.py)
LOOP_CASES = ("reverse", "histogram", "reduce_warp", "bfs_frontier",
              "lavamd", "kmeans", "streamcluster")
#: Table II's gaps among them: single-stage kernels only for naive, no
#: warp functions for loop_nowarp
NAIVE_RUNS = ("histogram", "kmeans", "streamcluster")
NOWARP_REFUSES = ("reduce_warp", "bfs_frontier")

#: the cases whose Dim3 refactorizations cuda refuses (lower_cuda._one_dim:
#: every dim3-free plain entry), and the dtype points it refuses, by the
#: wrapper's reason: CudaKernel.validate for a buffer of another dtype,
#: kernel_for for pathfinder's builder, which makes no native body but
#: for int32
CUDA_GEOMETRY_REFUSED = ("vecadd", "histogram", "reduce_shared",
                         "reduce_warp", "matmul_tiled", "stencil1d",
                         "softmax_row", "scan_block", "transpose_tiled",
                         "pixel_pipeline", "backprop_layer", "lud_diag",
                         "lavamd", "streamcluster")
CUDA_DTYPE_REFUSED = {
    ("vecadd", "f64"): "the hand-written kernel takes torch.float32",
    ("vecadd", "i32"): "the hand-written kernel takes torch.float32",
    ("reduce_shared", "f64"): "the hand-written kernel takes torch.float32",
    ("reduce_warp", "f64"): "the hand-written kernel takes torch.float32",
    ("matmul_tiled", "f64"): "the hand-written kernel takes torch.float32",
    ("stencil1d", "f64"): "the hand-written kernel takes torch.float32",
    ("softmax_row", "f64"): "the hand-written kernel takes torch.float32",
    ("scan_block", "f64"): "the hand-written kernel takes torch.float32",
    ("transpose_tiled", "f64"):
        "the hand-written kernel takes torch.float32",
    ("transpose_tiled", "i32"):
        "the hand-written kernel takes torch.float32",
    ("pixel_pipeline", "f64"): "the hand-written kernel takes torch.float32",
    ("pathfinder", "f32"): "no hand-written CUDA body",
    ("pathfinder", "f64"): "no hand-written CUDA body",
    ("needle_nw", "f32"): "the hand-written kernel takes torch.int32",
}


def _base_cell(case, backend, *, grain=1):
    entry = case.make(case.dtypes[0])
    cell, out = run_cell(entry, case, backend, case.dtypes[0], entry.grid,
                         entry.block, grain, device=CPU)
    return entry, cell, out


def _bytes(v) -> bytes:
    return conformance._host(v).tobytes()


# --- the matrix: every kernel x vector and cuda ------------------------------
@pytest.mark.parametrize("backend", ["vector", "cuda"])
@pytest.mark.parametrize("case", CASES.values(), ids=lambda c: c.name)
def test_matrix_base_cell(case, backend):
    _, cell, out = _base_cell(case, backend)
    assert cell.status == "pass", f"{cell.label()}: {cell.detail}"
    assert out is not None and all(
        getattr(v, "value", v).device.type == "cpu" for v in out.values())


@pytest.mark.parametrize("name", LOOP_CASES)
def test_loop_family_base_cells(name):
    """loop passes; loop_nowarp and naive pass bit for bit against it
    where they run the kernel, and are unsupport cells where Table II
    says they cannot express it."""
    rep = run_matrix(cases=[CASES[name]],
                     backends=("loop", "loop_nowarp", "naive"),
                     variants=False, device=CPU)
    assert not rep.disagreements, [c.detail for c in rep.disagreements]
    got = {c.backend: c for c in rep.cells}
    assert got["loop"].status == "pass"
    for backend, runs in (("loop_nowarp", name not in NOWARP_REFUSES),
                          ("naive", name in NAIVE_RUNS)):
        c = got[backend]
        if runs:
            assert c.status == "pass" and c.anchor == "loop"
            assert c.bit_required and c.bit_identical, c.label()
        else:
            assert c.status == "unsupport" and c.anchor is None, c.label()


# --- variant axes: a representative slice ------------------------------------
@pytest.mark.parametrize("name,backend", [
    ("vecadd", "vector"), ("reduce_shared", "vector"),
    ("histogram", "vector"), ("histogram", "loop"), ("reduce_warp", "loop"),
])
def test_grid_refactorization_invariant(name, backend):
    """2-D/3-D Dim3 launches of a linearized kernel == the 1-D launch."""
    case = CASES[name]
    tag = case.dtypes[0]
    entry = case.make(tag)
    variants = grid_variants(entry.grid)
    assert variants, f"{name}: grid {entry.grid} has no factorizations"
    base_cell_, base_out = run_cell(entry, case, backend, tag, entry.grid,
                                    entry.block, 1, device=CPU)
    assert base_cell_.status == "pass"
    for gv in variants:
        cell, out = run_cell(entry, case, backend, tag, gv, entry.block, 1,
                             device=CPU)
        assert cell.status == "pass", f"{cell.label()}: {cell.detail}"
        for k in out:
            assert _bytes(out[k]) == _bytes(base_out[k]), (
                f"{name}/{backend}: grid {gv} diverges from {entry.grid} "
                f"on {k!r}")


@pytest.mark.parametrize("name,backends", [
    ("vecadd", ("vector",)), ("scan_block", ("vector",)),
    ("needle_nw", ("vector",)), ("bfs_frontier", ("loop", "vector")),
])
def test_grain_tail_invariant(name, backends):
    """grain=3 leaves non-multiple tails in every fetch loop; results may
    not change."""
    case = CASES[name]
    tag = case.dtypes[0]
    entry = case.make(tag)
    for backend in backends:
        _, out1 = run_cell(entry, case, backend, tag, entry.grid,
                           entry.block, 1, device=CPU)
        cell, out3 = run_cell(entry, case, backend, tag, entry.grid,
                              entry.block, 3, device=CPU)
        assert cell.status == "pass", f"{cell.label()}: {cell.detail}"
        for k in out1:
            assert _bytes(out1[k]) == _bytes(out3[k]), (
                f"{name}/{backend}: grain=3 diverges on {k!r}")


@pytest.mark.parametrize("name,tag", [
    ("vecadd", "f64"), ("vecadd", "i32"), ("reduce_shared", "f64"),
    ("transpose_tiled", "i32"), ("pathfinder", "f32"), ("pathfinder", "f64"),
    ("needle_nw", "f32"),
])
@pytest.mark.parametrize("backend", ["loop", "vector"])
def test_dtype_variants(name, tag, backend):
    """The reference's dtype cells, which its own matrix cannot enter on
    this JAX (ROADMAP "Reference caveats"), under the port's switch: f64
    cells compute in float64 and meet DTYPE_TOL["f64"]."""
    case = CASES[name]
    assert tag in case.dtypes
    entry = case.make(tag)
    cell, out = run_cell(entry, case, backend, tag, entry.grid, entry.block,
                         1, device=CPU)
    assert cell.status == "pass", f"{cell.label()}: {cell.detail}"
    want = {"f32": torch.float32, "f64": torch.float64,
            "i32": torch.int32}[tag]
    assert all(out[k].dtype == want for k in entry.kernel.writes)


def test_cuda_refuses_geometry_and_dtype_as_unsupport_cells():
    """cuda sweeps the geometry and dtype axes; a wrapper refuses every
    variant point it was not written for before launching, and each
    refusal is an unsupport cell carrying the wrapper's message."""
    rep = run_matrix(backends=("cuda",), variants=True, device=CPU)
    assert not rep.disagreements, [c.label() for c in rep.disagreements]
    base = {c.kernel for c in rep.cells
            if c.status == "pass" and c.mode == "host"}
    assert base == set(CASES)
    geometry = [c for c in rep.cells if c.status == "unsupport"
                and c.dtype == CASES[c.kernel].dtypes[0]]
    assert {c.kernel for c in geometry} == set(CUDA_GEOMETRY_REFUSED)
    for c in geometry:
        assert "1-D grid and block expected" in c.detail, c.detail
        assert tuple(c.grid) != (c.grid[0], 1, 1)
    n_geometry = sum(len(grid_variants(CASES[n].make(CASES[n].dtypes[0])
                                       .grid))
                     for n in CUDA_GEOMETRY_REFUSED)
    assert len(geometry) == n_geometry
    dtype = {(c.kernel, c.dtype): c.detail for c in rep.cells
             if c.dtype != CASES[c.kernel].dtypes[0]}
    assert set(dtype) == set(CUDA_DTYPE_REFUSED)
    for key, why in CUDA_DTYPE_REFUSED.items():
        assert why in dtype[key], (key, dtype[key])
    assert all(c.status == "unsupport" for c in rep.cells
               if c.dtype != CASES[c.kernel].dtypes[0])


# --- the replay legs ---------------------------------------------------------
def test_chain_cases_grow_mode_cells():
    """A chain case sweeps device_resident cells on loop, vector and cuda
    and graph cells on loop and vector (the CPU's graph backends), each
    bit-anchored on the same backend's host-hop run; bfs, a corpus kernel
    of the frontend, adds its frontend cells on loop and vector, and, as
    every kernel, its optimized cells there."""
    rep = run_matrix(cases=[CASES["bfs_frontier"]],
                     backends=("loop", "vector", "cuda"), variants=True,
                     device=CPU)
    by_mode = {}
    for c in rep.cells:
        by_mode.setdefault(c.mode, []).append(c)
    assert set(by_mode) == {"host", "device_resident", "graph", "frontend",
                            "optimized"}
    assert not rep.disagreements
    assert {c.backend for c in by_mode["device_resident"]} == {
        "loop", "vector", "cuda"}
    assert {c.backend for c in by_mode["graph"]} == set(
        conformance.GRAPH_MODE_BACKENDS)
    assert {c.backend for c in by_mode["frontend"]} == set(
        conformance.FRONTEND_BACKENDS)
    assert [c.backend for c in by_mode["optimized"]] == list(
        conformance.OPTIMIZED_BACKENDS)
    for mode in ("device_resident", "graph", "frontend", "optimized"):
        for c in by_mode[mode]:
            assert c.anchor == f"{c.backend}/host"
            assert c.bit_required and c.bit_identical, c.label()
    assert rep.legs() == {"device_resident": ["loop", "vector", "cuda"],
                          "graph": ["loop", "vector"]}
    assert report_to_json(rep)["meta"]["legs"] == rep.legs()


def test_single_launch_cases_have_no_replay_mode_cells():
    # vecadd's cells of other modes are its optimized run and its
    # frontend twin's, on vector; cuda sweeps neither
    rep = run_matrix(cases=[CASES["vecadd"]], backends=("vector", "cuda"),
                     variants=True, device=CPU)
    assert {c.mode for c in rep.cells} == {"host", "optimized", "frontend"}
    assert [(c.backend, c.mode) for c in rep.cells if c.mode != "host"] == [
        ("vector", "optimized"), ("vector", "frontend")]
    assert rep.legs() == {"device_resident": [], "graph": []}


def test_graph_leg_runs_on_cuda_on_a_cuda_device():
    assert conformance.graph_mode_backends("cpu") == ("loop", "vector")
    assert conformance.graph_mode_backends("cuda") == ("cuda",)
    assert conformance.graph_mode_backends(torch.device("cuda", 0)) == (
        "cuda",)


def test_mode_axis_in_matrix_json():
    rep = run_matrix(cases=[CASES["needle_nw"]], backends=("vector",),
                     variants=True, device=CPU)
    js = report_to_json(rep)
    modes = {c["mode"] for c in js["cells"]}
    assert modes == {"host", "device_resident", "graph", "optimized",
                     "frontend"}
    labeled = [c for c in rep.cells if c.mode == "graph"]
    assert labeled and "mode=graph" in labeled[0].label()


@pytest.mark.parametrize("backend", ["vector", "cuda"])
def test_mode_cell_detects_divergent_device_replay(backend):
    """A device replay whose bits drift from host-hop fails its cell."""
    case = CASES["needle_nw"]
    base = case.make("i32")
    chain = base.chain
    # a poisoned update hook: advances the diagonal by 2, desyncing the
    # device-resident replay from the host-hop one
    bad_step = dataclasses.replace(chain.steps[0],
                                   update=lambda b: {"diag": b["diag"] + 2})
    bad_entry = dataclasses.replace(
        base, chain=dataclasses.replace(chain, steps=(bad_step,)))
    bad_case = dataclasses.replace(case, make=lambda tag: bad_entry)
    rep = run_matrix(cases=[bad_case], backends=(backend,), variants=True,
                     device=CPU)
    bad_cells = [c for c in rep.cells
                 if c.mode in ("device_resident", "graph")]
    assert bad_cells and all(c.status == "fail" for c in bad_cells)
    assert all("bits differ from host-hop" in c.detail
               or "oracle mismatch" in c.detail for c in bad_cells)
    host = [c for c in rep.cells if c.mode == "host"]
    assert host and all(c.status == "pass" for c in host)


# --- the report --------------------------------------------------------------
def test_matrix_report_structure():
    cases = [CASES["vecadd"], CASES["bfs_frontier"]]
    rep = run_matrix(cases=cases, backends=("loop", "naive", "cuda"),
                     variants=False, device=CPU)
    assert rep.n_kernels == 2
    assert not rep.disagreements
    js = report_to_json(rep)
    assert js["meta"]["n_kernels"] == 2
    assert js["meta"]["backends"] == ["loop", "naive", "cuda"]
    assert js["meta"]["device"] == "cpu"
    assert js["meta"]["torch"] == torch.__version__
    assert js["meta"]["n_cells"] == len(rep.cells) == 6
    assert js["summary"]["loop"]["pass"] == 2
    assert js["summary"]["cuda"]["pass"] == 2
    # naive cannot run bfs (barrier count) -> an unsupport cell, not a
    # disagreement; its vecadd cell owes loop's bits
    assert js["summary"]["naive"] == {"pass": 1, "fail": 0, "unsupport": 1,
                                      "skip": 0}
    naive_vecadd = next(c for c in rep.cells
                        if c.backend == "naive" and c.kernel == "vecadd")
    assert naive_vecadd.anchor == "loop" and naive_vecadd.bit_identical
    assert js["disagreements"] == []
    assert len(js["cells"]) == len(rep.cells)
    assert set(js["cells"][0]) == {f.name for f in dataclasses.fields(Cell)}
    assert all(c["devices"] is None for c in js["cells"])
    assert js["kernels"]["bfs_frontier"]["rodinia"] == "bfs"
    json.dumps(js, allow_nan=False)       # RFC 8259: no Infinity/NaN


def test_not_ported_legs_are_listed_and_make_no_cell(monkeypatch):
    """Every leg of the reference is ported, the shard legs last: nothing
    is listed as not ported, and pathfinder, a corpus chain, makes its
    frontend and optimized cells on vector and its shard_vector cells at
    each device count - bit for bit vector at 1 and 2 host workers, and a
    skip cell at 4, above the pool of 2."""
    monkeypatch.setenv("CUPBOP_HOST_DEVICES", "2")
    rep = run_matrix(cases=[CASES["pathfinder"]],
                     backends=("vector", "shard_vector"), variants=True,
                     device=CPU, device_counts=(1, 2, 4))
    meta = report_to_json(rep)["meta"]
    assert "not_ported" not in meta and not hasattr(conformance,
                                                    "NOT_PORTED")
    assert meta["device_count"] == 2
    for mode in ("frontend", "optimized"):
        (cell,) = [c for c in rep.cells if c.mode == mode]
        assert cell.status == "pass" and cell.bit_identical
        assert cell.anchor == "vector/host" and cell.bit_required
    shard = [c for c in rep.cells if c.backend == "shard_vector"]
    assert {c.devices for c in shard} == {1, 2, 4}
    for c in shard:
        if c.devices == 4:
            assert c.status == "skip" and "only 2 device" in c.detail
        elif c.mode == "host":
            assert c.status == "pass" and c.anchor == "vector"
            assert c.bit_required and c.bit_identical
        else:                        # device_resident: its own host cell
            assert c.mode == "device_resident" and c.status == "pass"
            assert c.anchor == "shard_vector/host" and c.bit_identical
    assert {c.mode for c in shard} == {"host", "device_resident"}
    assert {"shard", "shard_vector"} <= set(backend_names())
    assert rep.summary()["shard_vector"]["fail"] == 0


def test_anchors_carry_bits_between_calls(monkeypatch):
    """Phase 3c of chip_smoke.py runs one backend a call: vector's cells
    leave their bits in ``anchors`` and shard_vector's cells of a later
    call, without vector among its backends, are held against them; with
    no shared dict they carry no anchor."""
    monkeypatch.setenv("CUPBOP_HOST_DEVICES", "2")
    cases = [CASES[n] for n in ("vecadd", "histogram", "bfs_frontier")]
    anchors = {}
    run_matrix(cases=cases, backends=("vector",), variants=True, device=CPU,
               anchors=anchors)
    assert {k[:2] for k in anchors} == {(c.name, "vector") for c in cases}
    rep = run_matrix(cases=cases, backends=("shard_vector",), variants=True,
                     device=CPU, anchors=anchors)
    host = [c for c in rep.cells if c.mode == "host"]
    assert {c.devices for c in host} == {1, 2}
    assert all(c.anchor == "vector" and c.bit_required and c.bit_identical
               and c.status == "pass" for c in host)
    alone = run_matrix(cases=cases[:1], backends=("shard_vector",),
                       variants=False, device=CPU)
    assert all(c.anchor is None and c.status == "pass" for c in alone.cells)


# --- the frontend leg --------------------------------------------------------
def test_frontend_leg_covers_the_corpus_on_loop_and_vector():
    """Each corpus kernel's translated twin makes one cell per backend of
    FRONTEND_BACKENDS, which cuda is not in (it refuses a translated
    kernel), and every kernel an optimized cell per backend of
    OPTIMIZED_BACKENDS; the full CPU matrix over the seven backends at
    one host worker has 537 cells, 46 of them optimized."""
    assert conformance.FRONTEND_BACKENDS == ("loop", "vector")
    assert conformance.OPTIMIZED_BACKENDS == ("loop", "vector")
    axis = {"grain": conformance.VARIANT_BACKENDS,
            "geometry": conformance.GEOMETRY_BACKENDS,
            "dtype": conformance.DTYPE_BACKENDS,
            "device_resident": conformance.DEVICE_MODE_BACKENDS,
            "graph": conformance.graph_mode_backends(CPU),
            "optimized": conformance.OPTIMIZED_BACKENDS,
            "frontend": conformance.FRONTEND_BACKENDS}
    cells, front, optimized = 0, set(), set()
    for case in CASES.values():
        entries = {tag: case.make(tag) for tag in case.dtypes}
        for p in conformance._points(case, entries, variants=True):
            for b in backend_names():
                if p[0] == "base" or b in axis[p[0]]:
                    cells += 1
                    if p[0] == "frontend":
                        front.add((case.name, b))
                    if p[0] == "optimized":
                        optimized.add((case.name, b))
    assert front == {(n, b) for n in conformance.FRONTEND_CORPUS
                     for b in ("loop", "vector")}
    assert optimized == {(n, b) for n in CASES for b in ("loop", "vector")}
    assert cells == 537


def test_frontend_cell_detects_a_mistranslation(monkeypatch):
    """A twin whose source binds needle_nw's PENALTY to 3 fails its cell
    against the hand-written host bits; the host cell still passes."""
    real = conformance.frontend_twin
    monkeypatch.setattr(conformance, "frontend_twin",
                        lambda name: real(name, {"PENALTY": 3}))
    rep = run_matrix(cases=[CASES["needle_nw"]], backends=("vector",),
                     variants=False, device=CPU)
    assert [c.status for c in rep.cells] == ["pass"]
    rep = run_matrix(cases=[CASES["needle_nw"]], backends=("vector",),
                     variants=True, device=CPU)
    (bad,) = [c for c in rep.cells if c.mode == "frontend"]
    assert bad.status == "fail" and bad.bit_identical is False
    assert "ingested .cu bits differ" in bad.detail and "score" in bad.detail
    assert all(c.status == "pass" for c in rep.cells if c is not bad)


def test_frontend_cell_is_unsupport_when_translation_refuses(monkeypatch):
    def refuse(name):
        raise UnsupportedKernel("line 3: out of subset")

    monkeypatch.setattr(conformance, "frontend_twin", refuse)
    (cell,) = [c for c in run_matrix(cases=[CASES["reverse"]],
                                     backends=("loop",), variants=True,
                                     device=CPU).cells
               if c.mode == "frontend"]
    assert cell.status == "unsupport" and cell.detail == "line 3: out of subset"


def test_matrix_detects_disagreement():
    """A harness that cannot flag a broken backend verifies nothing; the
    broken backend then leaves the registry."""
    conformance._register_broken_backend()
    try:
        assert "broken" in backend_names()
        rep = run_matrix(cases=[CASES["vecadd"]],
                         backends=("vector", "broken"), variants=False,
                         device=CPU)
        assert len(rep.disagreements) == 1
        cell = rep.disagreements[0]
        assert cell.backend == "broken" and cell.status == "fail"
        assert "oracle mismatch" in cell.detail
        assert report_to_json(rep)["disagreements"]
    finally:
        unregister_backend("broken")
    assert "broken" not in backend_names()
    unregister_backend("broken")          # unknown names are a no-op


def test_unknown_backend_raises_before_any_cell():
    with pytest.raises(UnknownBackend):
        run_matrix(cases=[CASES["vecadd"]], backends=("tpu_v7",),
                   device=CPU)


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_matrix(cases=[CASES["vecadd"]], backends=("vector",),
                   variants=False)
    case = CASES["vecadd"]
    entry = case.make("f32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cell(entry, case, "vector", "f32", entry.grid, entry.block, 1)


def test_cell_label_roundtrip():
    c = Cell(kernel="k", backend="cuda", grid=(4, 2, 1), block=(64, 1, 1),
             dtype="f32", grain=3, devices=None, status="pass",
             mode="graph")
    assert c.label() == ("k/cuda grid=(4, 2, 1) block=(64, 1, 1) f32 "
                         "grain=3 mode=graph")


# --- the CLI -----------------------------------------------------------------
def _cli(*argv, tmp_path):
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src")]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.core.conformance", *argv],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_cli_gate_passes_and_writes_the_report(tmp_path):
    res = _cli("--no-variants", "--kernels", "vecadd", "--device", "cpu",
               "--json", "m.json", tmp_path=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "conformance gate: passed (7 cells, 1 kernels)" in res.stdout
    js = json.loads((tmp_path / "m.json").read_text())
    assert js["meta"]["device"] == "cpu"
    assert {c["backend"] for c in js["cells"]} == set(backend_names())
    assert all(c["status"] == "pass" for c in js["cells"])


def test_cli_inject_disagreement_trips_the_gate(tmp_path):
    res = _cli("--no-variants", "--kernels", "reverse", "--device", "cpu",
               "--inject-disagreement", tmp_path=tmp_path)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "conformance gate: FAILED (1 disagreement(s))" in res.stderr
    assert "reverse/broken" in res.stderr


def test_cli_refuses_an_unknown_kernel():
    with pytest.raises(SystemExit, match="unknown kernel"):
        conformance.main(["--kernels", "no_such_kernel", "--device", "cpu"])


def test_bits_compare_the_host_copy_of_each_buffer():
    out = {"a": torch.arange(4, dtype=torch.int32),
           "b": torch.ones(2, dtype=torch.float64)}
    bits = conformance._bits(out, exclude=("b",))
    assert bits == {"a": np.arange(4, dtype=np.int32).tobytes()}
