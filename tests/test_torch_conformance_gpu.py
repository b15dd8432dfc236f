"""The conformance matrix's ``cuda`` column on the card.

Every test here is marked ``gpu`` and skips without a CUDA device; on a
machine with one they run with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_conformance_gpu.py``.  The file imports neither JAX nor
the reference package.  Each passing ``cuda`` cell must have launched its
kernels (their ``launches`` counts, which only a launch on the card adds
to), the graph leg of every chain runs on ``cuda`` as a
``torch.cuda.CUDAGraph`` bit for bit its host cell, and a refused variant
point launches nothing.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cuda_suite, lower_cuda  # noqa: E402
from repro_torch.core.conformance import build_cases, run_cell, run_matrix  # noqa: E402

CASES = {c.name: c for c in build_cases()}
CHAINS = ("bfs_frontier", "pathfinder", "needle_nw", "srad_step", "nn",
          "kmeans", "hotspot")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _zero():
    for kern in lower_cuda.KERNELS.values():
        kern.launches = 0


def _counts() -> dict[str, int]:
    return {n: k.launches for n, k in lower_cuda.KERNELS.items()}


def _kernels(entry) -> set[str]:
    return {s.kernel.name for s in cuda_suite.entry_steps(entry)}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_base_cell_launches_its_kernels(card, name):
    case = CASES[name]
    entry = case.make(case.dtypes[0])
    _zero()
    cell, out = run_cell(entry, case, "cuda", case.dtypes[0], entry.grid,
                         entry.block, 1, device=card)
    torch.cuda.synchronize()
    assert cell.status == "pass", f"{cell.label()}: {cell.detail}"
    counts = _counts()
    mine = _kernels(entry)
    assert all(counts[k] >= 1 for k in mine), counts
    assert not {k: v for k, v in counts.items() if v and k not in mine}
    assert all(getattr(v, "value", v).device.type == "cuda"
               for v in out.values())


@pytest.mark.gpu
@pytest.mark.parametrize("name", CHAINS)
def test_cuda_replay_legs_on_the_card(card, name):
    """The device-resident and graph legs of each chain run on cuda, bit
    for bit its host cell, and launch the chain's kernels."""
    _zero()
    rep = run_matrix(cases=[CASES[name]], backends=("cuda",), variants=True,
                     device=card)
    assert not rep.disagreements, [c.detail for c in rep.disagreements]
    assert rep.legs() == {"device_resident": ["cuda"], "graph": ["cuda"]}
    for mode in ("device_resident", "graph"):
        (cell,) = [c for c in rep.cells if c.mode == mode]
        assert cell.status == "pass" and cell.bit_identical, cell.label()
        assert cell.anchor == "cuda/host"
    counts = _counts()
    assert all(counts[k] >= 3 for k in _kernels(CASES[name].make(
        CASES[name].dtypes[0]))), counts


@pytest.mark.gpu
def test_refused_variant_points_launch_nothing(card):
    case = CASES["vecadd"]
    _zero()
    rep = run_matrix(cases=[case], backends=("cuda",), variants=True,
                     device=card)
    statuses = [(c.grid, c.dtype, c.status) for c in rep.cells]
    assert statuses[0][2] == "pass"
    assert all(s == "unsupport" for _, _, s in statuses[1:])
    assert len(statuses) == 5          # base, 2 geometries, f64, i32
    assert _counts()["vecadd"] == 1    # the base cell's launch alone


@pytest.mark.gpu
def test_vector_and_cuda_matrix_on_the_card(card):
    """vector's geometry, grain and f32/f64/i32 cells on CUDA tensors, and
    the graph leg on cuda alone (a CUDA capture refuses vector's
    host-scalar copies)."""
    cases = [CASES[n] for n in ("vecadd", "reduce_shared", "transpose_tiled",
                                "pathfinder")]
    rep = run_matrix(cases=cases, backends=("vector", "cuda"),
                     variants=True, device=card)
    assert not rep.disagreements, [c.label() + c.detail
                                   for c in rep.disagreements]
    assert rep.device.startswith("cuda")
    assert rep.legs() == {"device_resident": ["vector", "cuda"],
                          "graph": ["cuda"]}
    vec = [c for c in rep.cells if c.backend == "vector"]
    assert all(c.status == "pass" for c in vec)
    assert {c.dtype for c in vec} == {"f32", "f64", "i32"}
