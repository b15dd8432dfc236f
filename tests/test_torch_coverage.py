"""The port's Table-II sweep and gate (``benchmarks/torch_coverage.py`` and
``benchmarks/torch_check_coverage.py``), on the CPU.

The structure of ``tests/test_coverage.py``: the sweep is replaced by
small fake tables so that the percentage arithmetic, ``--update`` and
every branch of the gate (count regression, percentage dilution, suite
shrink, missing baseline, ``--disable``, the JSON artifact) run in
milliseconds; one real sweep runs the cheap columns (``vector`` and
``cuda``, the kernels' plain versions on CPU tensors); and the committed
baseline is held against the reference's, with ``cuda`` where the
reference has ``pallas``.
"""
import importlib.util
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

_BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_BENCH, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod      # torch_check_coverage imports torch_coverage
    spec.loader.exec_module(mod)
    return mod


torch_coverage = _load("torch_coverage")
check_coverage = _load("torch_check_coverage")

FWS = ("loop", "naive")
CPU = ["--device", "cpu"]


def _table(rows):
    """rows: {kernel: {fw: status}} -> sweep-shaped {k: (row, features)}."""
    return {k: (dict(v), ("feat",)) for k, v in rows.items()}


def _patch_sweep(monkeypatch, table, fws=FWS):
    monkeypatch.setattr(
        torch_coverage, "run",
        lambda device=None, seconds=None, backends=None: {
            k: (dict(r), f) for k, (r, f) in table.items()})
    monkeypatch.setattr(torch_coverage, "frameworks", lambda: fws)


# --- percentages() -----------------------------------------------------------
def test_percentages_unsupport_and_incorrect_count_against():
    t = _table({
        "a": {"loop": "correct", "naive": "correct"},
        "b": {"loop": "correct", "naive": "unsupport"},
        "c": {"loop": "correct", "naive": "unsupport"},
        "d": {"loop": "incorrect", "naive": "unsupport"},
    })
    pct = torch_coverage.percentages(t)
    assert pct["loop"] == 75.0       # incorrect is not coverage
    assert pct["naive"] == 25.0      # unsupport dilutes, never skipped


def test_percentages_empty_table_is_zero_per_registered_backend():
    pct = torch_coverage.percentages({})
    assert set(pct) == set(torch_coverage.frameworks())
    assert set(pct) == {"loop", "loop_nowarp", "naive", "vector", "cuda"}
    assert all(v == 0.0 for v in pct.values())


def test_paper_figures_constants_and_line():
    assert torch_coverage.PAPER_CUPBOP_PCT == 69.6
    assert torch_coverage.PAPER_PRIOR_PCT == 56.6
    line = torch_coverage.paper_line({"loop": 100.0, "naive": 21.7})
    assert "CuPBoP 69.6% vs prior 56.6%" in line
    assert "loop 100.0% naive 21.7%" in line


def test_ordering_is_the_papers():
    good = {"naive": 5, "loop_nowarp": 21, "loop": 23, "vector": 23,
            "cuda": 23}
    assert torch_coverage.ordering_holds(good)
    for fw, n in (("cuda", 22), ("loop_nowarp", 23), ("naive", 21)):
        assert not torch_coverage.ordering_holds({**good, fw: n})


def test_coverage_main_fails_when_the_ordering_breaks(monkeypatch, capsys):
    fws = ("loop", "loop_nowarp", "naive", "vector", "cuda")
    rows = {"a": dict.fromkeys(fws, "correct"),
            "b": {**dict.fromkeys(fws, "correct"), "naive": "unsupport"},
            "c": {**dict.fromkeys(fws, "correct"), "naive": "unsupport",
                  "loop_nowarp": "unsupport"}}
    _patch_sweep(monkeypatch, _table(rows), fws)
    assert torch_coverage.main(CPU) == 0
    out = capsys.readouterr().out
    assert "paper_ordering,1" in out and "CuPBoP 69.6%" in out
    rows["c"]["cuda"] = "incorrect"
    _patch_sweep(monkeypatch, _table(rows), fws)
    assert torch_coverage.main(CPU) == 1


# --- torch_check_coverage: --update round-trip -------------------------------
def test_update_roundtrip_then_gate_passes(tmp_path, monkeypatch):
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"},
        "b": {"loop": "correct", "naive": "unsupport"},
        "c": {"loop": "correct", "naive": "unsupport"},
    }))
    base = tmp_path / "baseline.json"
    assert check_coverage.main(["--update", "--baseline", str(base),
                                *CPU]) == 0
    data = json.loads(base.read_text())
    assert data == {"n_kernels": 3, "backends": {"loop": 3, "naive": 1},
                    "percent": {"loop": 100.0, "naive": 33.3},
                    "device": "cpu"}
    assert check_coverage.main(["--baseline", str(base), *CPU]) == 0


def test_gate_trips_on_count_regression(tmp_path, monkeypatch):
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"},
        "b": {"loop": "correct", "naive": "correct"}}))
    base = tmp_path / "baseline.json"
    assert check_coverage.main(["--update", "--baseline", str(base),
                                *CPU]) == 0
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"},
        "b": {"loop": "correct", "naive": "incorrect"}}))
    assert check_coverage.main(["--baseline", str(base), *CPU]) == 1


def test_gate_trips_on_percent_dilution(tmp_path, monkeypatch):
    """Counts stay flat while the suite grows: only the percentage branch
    catches this."""
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"},
        "b": {"loop": "correct", "naive": "correct"}}))
    base = tmp_path / "baseline.json"
    assert check_coverage.main(["--update", "--baseline", str(base),
                                *CPU]) == 0
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"},
        "b": {"loop": "correct", "naive": "correct"},
        "c": {"loop": "unsupport", "naive": "unsupport"}}))
    assert check_coverage.main(["--baseline", str(base), *CPU]) == 1


def test_gate_trips_on_suite_shrink(tmp_path, monkeypatch):
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "unsupport"},
        "b": {"loop": "correct", "naive": "unsupport"}}))
    base = tmp_path / "baseline.json"
    assert check_coverage.main(["--update", "--baseline", str(base),
                                *CPU]) == 0
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "unsupport"}}))
    assert check_coverage.main(["--baseline", str(base), *CPU]) == 1


def test_gate_trips_when_a_backend_leaves_the_registry(tmp_path,
                                                       monkeypatch):
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"}}))
    base = tmp_path / "baseline.json"
    assert check_coverage.main(["--update", "--baseline", str(base),
                                *CPU]) == 0
    _patch_sweep(monkeypatch, _table({"a": {"loop": "correct"}}),
                 fws=("loop",))
    assert check_coverage.main(["--baseline", str(base), *CPU]) == 1


def test_gate_allows_growth_with_hint(tmp_path, monkeypatch, capsys):
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "unsupport"}}))
    base = tmp_path / "baseline.json"
    assert check_coverage.main(["--update", "--baseline", str(base),
                                *CPU]) == 0
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"}}))
    assert check_coverage.main(["--baseline", str(base), *CPU]) == 0
    assert "refresh with" in capsys.readouterr().out


def test_missing_baseline_is_an_error(tmp_path, monkeypatch):
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"}}))
    assert check_coverage.main(
        ["--baseline", str(tmp_path / "nope.json"), *CPU]) == 2


def test_the_gate_runs_on_the_card_by_default(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _patch_sweep(monkeypatch, _table({"a": {"loop": "correct"}}),
                 fws=("loop",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_coverage.main(["--baseline", str(tmp_path / "b.json")])


# --- --disable self-test + --json artifact -----------------------------------
def test_disable_marks_kernel_unsupported(monkeypatch):
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"},
        "b": {"loop": "correct", "naive": "correct"}}))
    counts, pct, n = check_coverage.current_counts(disable="b",
                                                   device="cpu")
    assert n == 2
    assert counts == {"loop": 1, "naive": 1}
    assert pct == {"loop": 50.0, "naive": 50.0}


def test_disable_unknown_kernel_raises(monkeypatch):
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"}}))
    with pytest.raises(SystemExit):
        check_coverage.current_counts(disable="no_such_kernel",
                                      device="cpu")


def test_json_artifact_written_even_when_gate_fails(tmp_path, monkeypatch):
    _patch_sweep(monkeypatch, _table({
        "a": {"loop": "correct", "naive": "correct"}}))
    base = tmp_path / "baseline.json"
    assert check_coverage.main(["--update", "--baseline", str(base),
                                *CPU]) == 0
    art = tmp_path / "report.json"
    assert check_coverage.main(
        ["--baseline", str(base), "--json", str(art),
         "--disable", "a", *CPU]) == 1
    report = json.loads(art.read_text())
    assert report == {"n_kernels": 1, "backends": {"loop": 0, "naive": 0},
                      "percent": {"loop": 0.0, "naive": 0.0},
                      "device": "cpu"}


# --- a real sweep, and the committed baseline --------------------------------
def test_real_sweep_of_vector_and_cuda_on_the_cpu(monkeypatch):
    """The two cheap columns over all 23 entries, end to end: every entry
    correct on both, as the committed baseline says."""
    seconds = {}
    table = torch_coverage.run(device="cpu", seconds=seconds,
                               backends=("vector", "cuda"))
    assert len(table) == 23 and set(seconds) == {"vector", "cuda"}
    bad = {k: row for k, (row, _) in table.items()
           if set(row.values()) != {"correct"}}
    assert not bad, bad
    with open(os.path.join(_BENCH, "torch_coverage_baseline.json")) as f:
        base = json.load(f)
    cov = torch_coverage.counts(table)
    assert cov == {fw: base["backends"][fw] for fw in ("vector", "cuda")}


def test_committed_baseline_matches_the_reference_baseline():
    """The checked-in baseline describes the 23-kernel suite with the
    reference's counts, cuda where the reference has pallas, and records
    the device of the run that wrote it (hand-edit guard)."""
    with open(os.path.join(_BENCH, "torch_coverage_baseline.json")) as f:
        base = json.load(f)
    with open(os.path.join(_BENCH, "coverage_baseline.json")) as f:
        ref = json.load(f)
    assert base["n_kernels"] == ref["n_kernels"] == 23
    assert base["device"] in ("cpu", "cuda")
    assert set(base["percent"]) == set(base["backends"]) == {
        "loop", "loop_nowarp", "naive", "vector", "cuda"}
    for fw, cnt in base["backends"].items():
        want = ref["backends"]["pallas" if fw == "cuda" else fw]
        assert cnt == want
        assert base["percent"][fw] == round(100.0 * cnt / 23, 1)
        assert base["percent"][fw] == ref["percent"][
            "pallas" if fw == "cuda" else fw]
    assert base["backends"] == {"loop": 23, "loop_nowarp": 21, "naive": 5,
                                "vector": 23, "cuda": 23}
    assert torch_coverage.ordering_holds(base["backends"])
