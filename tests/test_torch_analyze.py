"""kernelcheck in the port (``repro_torch.core.analyze``): races,
declaration audit, fusion.

The structure of ``tests/test_analyze.py``, on the port and on the CPU:
(1) the whole 23-entry suite comes back *clean* - the declarations the
runtime trusts (reads/writes/combines/donates) are verified, not assumed -
and (2) deliberately broken fixture kernels trip each finding kind with
the right kernel/stage/buffer named, because a sanitizer that cannot find
planted bugs proves nothing (the gate's ``--inject-*`` flags are these
same fixtures).  The port's stages reach their buffers through
``index.take`` / ``index.put`` and torch calls; each path is recorded.
The cross-framework column is ``tests/test_torch_analyze_parity.py``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import analyze, api, cuda_suite, index  # noqa: E402
from repro_torch.core.analyze import (  # noqa: E402
    Finding,
    FusionVerdict,
    SanitizerError,
    TrackedArray,
    analyze_entry,
    analyze_kernel,
    report_to_json,
)
from repro_torch.core.api import launch  # noqa: E402
from repro_torch.core.kernel import KernelDef  # noqa: E402

CPU = "cpu"
SUITE = cuda_suite.build_suite(scale=1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def suite_reports():
    """Every entry's reports, analyzed once for the module."""
    return {e.name: analyze_entry(e, device=CPU) for e in SUITE}


def _kinds(report):
    return {f.kind for f in report.findings}


# --- the suite is clean ------------------------------------------------------
@pytest.mark.parametrize("entry", SUITE, ids=lambda e: e.name)
def test_suite_entry_clean(suite_reports, entry):
    reports = suite_reports[entry.name]
    assert reports
    for report in reports:
        assert report.clean, "\n".join(str(f) for f in report.findings)


def test_fusion_marks_at_least_three_suite_pairs_mergeable(suite_reports):
    verdicts = [v for rs in suite_reports.values() for r in rs
                for v in r.fusion]
    mergeable = [v for v in verdicts if v.mergeable]
    assert len(mergeable) >= 3, [str(v) for v in verdicts]
    # the known-provable pairs: matmul's private-init prologue and its
    # shared->global epilogue, and lud's last-step -> store epilogue
    got = {(v.kernel, v.pair) for v in mergeable}
    assert ("matmul_tiled", (0, 1)) in got
    assert any(k == "lud_diag" for k, _ in got)


def test_fusion_keeps_reduction_barriers(suite_reports):
    (report,) = suite_reports["reduce_shared"]
    assert report.clean
    # every reduction level reads another thread's slot: no pair mergeable
    assert all(not v.mergeable for v in report.fusion)


def test_fusion_sees_value_preserving_writes():
    """Soundness regression: a shared write that stores an *unchanged*
    value under the sample inputs (here: zeros over zero-initialized
    shared) still orders against other threads - the pair must NOT be
    proven mergeable, or the optimizer fuses a real cross-thread tree
    (the nn argmin select bug)."""
    def wr(ctx, st):
        return st.set_shared(s=index.put(
            st.shared["s"], ctx.tid, index.take(st.glob["x"], ctx.tid)))

    def rd(ctx, st):
        v = index.take(st.shared["s"], torch.clamp(ctx.tid + 1, max=3))
        return st.set_glob(y=index.put(st.glob["y"], ctx.tid, v))

    k = KernelDef("noop_write", (wr, rd), writes=("y",), reads=("x", "y"),
                  shared={"s": ((4,), torch.float32)})
    art = analyze.analyze_fusion(
        k, grid=1, block=4,
        args={"x": torch.zeros(4), "y": torch.zeros(4)})
    (v,) = art["verdicts"]
    assert not v["mergeable"]
    assert "different thread" in v["reason"]
    # and the no-op write keeps the cell non-private (no scalarization)
    assert not art["shared"]["s"]["private"]


# --- planted bugs: each finding kind fires with the right location -----------
def test_planted_race_caught():
    kernel, grid, block, args = analyze.planted_race()
    report = analyze_kernel(kernel, grid=grid, block=block, args=args)
    (f,) = [f for f in report.findings if f.kind == "shared-race"]
    assert f.kernel == "planted_race"
    assert f.buffer == "s"
    assert f.stage == 0
    assert "read-write" in f.detail


def test_planted_write_write_race_caught():
    def clash(ctx, st):
        # every thread stores its tid into slot 0: a WW race
        s = index.put(st.shared["s"], torch.zeros_like(ctx.tid), ctx.tid + 1)
        return st.set_shared(s=s)

    def store(ctx, st):
        out = index.put(st.glob["out"], ctx.tid,
                        index.take(st.shared["s"], 0))
        return st.set_glob(out=out)

    k = KernelDef("ww", (clash, store), writes=("out",), reads=("out",),
                  shared={"s": ((4,), torch.int32)})
    report = analyze_kernel(k, grid=1, block=8,
                            args={"out": torch.zeros(8, dtype=torch.int32)})
    (f,) = [f for f in report.findings if f.kind == "shared-race"]
    assert f.stage == 0 and f.buffer == "s"
    assert "write-write" in f.detail


def test_masked_writeback_is_not_a_race():
    # the IR's conditional-write idiom: inactive threads store the value
    # already present - kernelcheck must not call that a race
    def level(ctx, st):
        s = st.shared["s"]
        active = ctx.tid < 4
        v = torch.where(active,
                        index.take(s, ctx.tid)
                        + index.take(s, torch.clamp(ctx.tid + 4, max=7)),
                        index.take(s, ctx.tid))
        return st.set_shared(s=index.put(s, ctx.tid, v))

    def seed(ctx, st):
        return st.set_shared(s=index.put(
            st.shared["s"], ctx.tid, index.take(st.glob["x"], ctx.tid)))

    def store(ctx, st):
        out = index.put(st.glob["out"], ctx.tid,
                        index.take(st.shared["s"], ctx.tid))
        return st.set_glob(out=out)

    k = KernelDef("masked", (seed, level, store), writes=("out",),
                  reads=("x", "out"), shared={"s": ((8,), torch.float32)})
    report = analyze_kernel(k, grid=1, block=8,
                            args={"x": torch.arange(8.0),
                                  "out": torch.zeros(8)})
    assert report.clean, "\n".join(str(f) for f in report.findings)


def test_planted_undeclared_read_caught():
    kernel, grid, block, args = analyze.planted_undeclared_read()
    report = analyze_kernel(kernel, grid=grid, block=block, args=args)
    (f,) = [f for f in report.findings if f.kind == "undeclared-read"]
    assert f.buffer == "bias"
    assert "bias" in (f.suggestion or "")


def test_planted_bad_combine_caught():
    kernel, grid, block, args = analyze.planted_bad_combine()
    report = analyze_kernel(kernel, grid=grid, block=block, args=args)
    (f,) = [f for f in report.findings if f.kind == "combine-mismatch"]
    assert f.buffer == "out"
    assert '"sum"' in (f.suggestion or "")


def test_undeclared_write_and_unused_read_caught():
    def stage(ctx, st):
        extra = index.put(st.glob["extra"], ctx.tid, ctx.tid)
        out = index.put(st.glob["out"], ctx.tid, ctx.tid * 2)
        return st.set_glob(out=out, extra=extra)

    k = KernelDef("drift", (stage,), writes=("out",),
                  reads=("out", "ghost"))
    report = analyze_kernel(k, grid=1, block=16,
                            args={"out": torch.zeros(16, dtype=torch.int32),
                                  "extra": torch.zeros(16, dtype=torch.int32),
                                  "ghost": torch.zeros(4, dtype=torch.int32)})
    kinds = _kinds(report)
    assert "undeclared-write" in kinds    # extra written, not declared
    assert "unused-read" in kinds         # ghost declared, never touched
    assert "undeclared-read" in kinds     # extra's scatter implies a read
    by_kind = {f.kind: f for f in report.findings}
    assert by_kind["undeclared-write"].buffer == "extra"
    assert by_kind["unused-read"].buffer == "ghost"


def test_missing_reads_suggested():
    def stage(ctx, st):
        out = index.put(st.glob["out"], ctx.tid,
                        index.take(st.glob["x"], ctx.tid))
        return st.set_glob(out=out)

    k = KernelDef("noreads", (stage,), writes=("out",))
    report = analyze_kernel(k, grid=1, block=8,
                            args={"x": torch.arange(8.0),
                                  "out": torch.zeros(8)})
    (f,) = [f for f in report.findings if f.kind == "missing-reads"]
    assert "'x'" in f.suggestion and "'out'" in f.suggestion


def _oob_kernel(drop):
    def stage(ctx, st):
        # the index runs past the end; drop= says whether the author
        # asked for the drop
        out = index.put(st.glob["out"], ctx.tid * 2, 1.0, drop=drop)
        return st.set_glob(out=out)

    return KernelDef("oob" if not drop else "oob_ok", (stage,),
                     writes=("out",), reads=("out",))


def test_oob_write_without_drop_caught():
    report = analyze_kernel(_oob_kernel(False), grid=1, block=8,
                            args={"out": torch.zeros(8)})
    (f,) = [f for f in report.findings if f.kind == "oob-write"]
    assert f.buffer == "out" and f.stage == 0
    assert "4 scatter position(s)" in f.detail
    assert "drop" in (f.suggestion or "")


def test_oob_write_with_explicit_drop_is_clean():
    report = analyze_kernel(_oob_kernel(True), grid=1, block=8,
                            args={"out": torch.zeros(8)})
    assert report.clean


def test_drop_flag_leaves_the_bits_alone():
    """``drop`` informs kernelcheck only: both stores drop alike."""
    for backend in ("vector", "loop"):
        asked, plain = (launch(_oob_kernel(d), grid=1, block=8,
                               args={"out": torch.zeros(8)},
                               backend=backend)["out"]
                        for d in (True, False))
        assert torch.equal(asked, plain)
        assert asked.tolist() == [1.0, 0.0] * 4


def test_donation_hazard_caught():
    def overwrite(ctx, st):
        return st.set_glob(buf=index.put(st.glob["buf"], ctx.tid,
                                         ctx.tid * 1.0))

    def reread(ctx, st):
        out = index.put(st.glob["out"], ctx.tid,
                        index.take(st.glob["buf"], 7 - ctx.tid))
        return st.set_glob(out=out)

    k = KernelDef("hazard", (overwrite, reread), writes=("buf", "out"),
                  reads=("buf", "out"), donates=("buf",))
    report = analyze_kernel(k, grid=1, block=8,
                            args={"buf": torch.ones(8),
                                  "out": torch.zeros(8)})
    (f,) = [f for f in report.findings if f.kind == "donation-hazard"]
    assert f.buffer == "buf" and f.stage == 1


def test_incomplete_combines_caught():
    def stage(ctx, st):
        a = index.put(st.glob["a"], ctx.tid, 1.0)
        b = index.put(st.glob["b"], ctx.tid, 2.0)
        return st.set_glob(a=a, b=b)

    k = KernelDef("partial", (stage,), writes=("a", "b"),
                  reads=("a", "b"), combines={"a": "sum"})
    report = analyze_kernel(k, grid=1, block=8,
                            args={"a": torch.zeros(8), "b": torch.zeros(8)})
    (f,) = [f for f in report.findings if f.kind == "incomplete-combines"]
    assert f.buffer == "b"


def test_concat_ownership_violation_caught():
    def stage(ctx, st):
        # every block writes row 0: not an owned-slice pattern
        y = index.put(st.glob["y"], torch.zeros_like(ctx.tid),
                      ctx.tid * 1.0 + ctx.bid)
        return st.set_glob(y=y)

    k = KernelDef("notconcat", (stage,), writes=("y",), reads=("y",),
                  combines={"y": "concat"})
    report = analyze_kernel(k, grid=4, block=8,
                            args={"y": torch.zeros(4)})
    assert any(f.kind == "combine-mismatch" and "owned slice" in f.detail
               for f in report.findings)


# --- how a stage reaches a tracked buffer -------------------------------------
def test_torch_calls_and_methods_read_the_whole_buffer():
    """A torch call (``__torch_function__``), a tensor method and an
    operator each record a whole-buffer read and return a plain tensor;
    metadata (shape, dtype, device) records nothing."""
    rec = analyze._BufRec("x", "glob", (4,), 4)
    rec.begin_stage()
    x = TrackedArray(torch.arange(4.0), rec)
    assert x.shape == (4,) and x.dtype == torch.float32 and x.dim() == 1
    assert x.device.type == "cpu" and rec.cur.read_ops == 0
    for got in (torch.where(torch.ones(4, dtype=torch.bool), x, 0.0),
                x.clone(), x + 1, 1 + x, -x, torch.ones(4) * x):
        assert type(got) is torch.Tensor
    assert rec.cur.read_all and rec.cur.read_ops == 6
    assert not rec.cur.reads


def test_gathers_and_scatters_record_per_thread_footprints():
    rec = analyze._BufRec("s", "shared", (8,), 4)
    rec.begin_stage()
    s = TrackedArray(torch.zeros(8), rec)
    tid = torch.arange(4, dtype=torch.int32)
    index.take(s, tid * 2 + 9)                     # clamps to 7
    s2 = index.put(s, tid + 2, torch.tensor([1.0, 0.0, 1.0, 0.0]))
    assert isinstance(s2, TrackedArray) and s2._rec is rec
    assert rec.cur.reads == {7: {0, 1, 2, 3}}
    assert rec.cur.touched == {2: {0}, 3: {1}, 4: {2}, 5: {3}}
    assert rec.cur.writes == {2: {0}, 4: {2}}      # value-changing only
    assert not rec.cur.read_all and rec.cur.oob == 0
    ctx = analyze.AnalyzeCtx(bid=0, tid=tid, block_dim=4, grid_dim=1,
                             backend="vector")
    s3 = ctx.atomic_add(s2, torch.zeros_like(tid), 1.0)
    assert rec.cur.accums == {0: {0, 1, 2, 3}} and "add" in rec.cur.accum_kinds
    assert s3.value.tolist()[:6] == [4.0, 0.0, 1.0, 0.0, 1.0, 0.0]


def test_changed_locs_is_nan_stable():
    old = torch.tensor([float("nan"), 1.0, 2.0])
    new = torch.tensor([float("nan"), 1.0, 3.0])
    assert analyze._changed_locs(old, new) == {2}


# --- definition-time combines validation (kernel.__post_init__) --------------
def test_combines_keys_validated_at_definition():
    def stage(ctx, st):
        return st

    with pytest.raises(ValueError, match="not in writes"):
        KernelDef("bad", (stage,), writes=("y",), combines={"x": "sum"})
    with pytest.raises(ValueError, match="combine mode"):
        KernelDef("bad", (stage,), writes=("y",), combines={"y": "xor"})


# --- launch-path integration -------------------------------------------------
def _dbl():
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        return st.set_glob(out=index.put(
            st.glob["out"], gid, index.take(st.glob["x"], gid) * 2))

    return KernelDef("dbl", (stage,), writes=("out",), reads=("x", "out"))


def test_sanitize_launch_raises_on_findings():
    kernel, grid, block, args = analyze.planted_race()
    with pytest.raises(SanitizerError, match="shared-race"):
        launch(kernel, grid=grid, block=block, args=args, sanitize=True)


@pytest.mark.parametrize("how", ["launch", "chevrons", "env"])
def test_sanitize_launch_clean_kernel_runs_and_memoizes(monkeypatch, how):
    k = _dbl()
    args = {"x": torch.arange(64.0), "out": torch.zeros(64)}
    for _ in range(2):
        if how == "launch":
            out = launch(k, grid=2, block=32, args=args, sanitize=True)
        elif how == "chevrons":
            out = k[2, 32].on(sanitize=True)(args)
        else:
            monkeypatch.setenv("CUPBOP_SANITIZE", "1")
            out = k[2, 32](args)
        np.testing.assert_allclose(out["out"].numpy(), np.arange(64.0) * 2)
    assert len(getattr(k, "_kernelcheck_ok")) == 1  # one memoized verdict


def test_sanitize_env_var(monkeypatch):
    kernel, grid, block, args = analyze.planted_undeclared_read()
    monkeypatch.setenv("CUPBOP_SANITIZE", "1")
    assert analyze.sanitize_env_enabled()
    with pytest.raises(SanitizerError, match="undeclared-read"):
        launch(kernel, grid=grid, block=block, args=args)
    monkeypatch.setenv("CUPBOP_SANITIZE", "0")
    assert not analyze.sanitize_env_enabled()
    out = launch(kernel, grid=grid, block=block, args=args)
    assert "out" in out


def test_sanitize_false_overrides_env(monkeypatch):
    kernel, grid, block, args = analyze.planted_undeclared_read()
    monkeypatch.setenv("CUPBOP_SANITIZE", "1")
    out = launch(kernel, grid=grid, block=block, args=args, sanitize=False)
    assert "out" in out
    out = kernel[grid, block].on(sanitize=False)(args)
    assert "out" in out


def test_sanitize_runs_before_anything_is_built():
    """No fallback: a finding raises before the launch cache is touched."""
    kernel, grid, block, args = analyze.planted_race()
    api.cache_clear()
    with pytest.raises(SanitizerError):
        launch(kernel, grid=grid, block=block, args=args, sanitize=True,
               backend="cuda")
    assert api.cache_stats().misses == 0


# --- report plumbing ---------------------------------------------------------
def test_report_to_json_shape():
    kernel, grid, block, args = analyze.planted_race()
    report = analyze_kernel(kernel, grid=grid, block=block, args=args)
    doc = report_to_json([report])
    assert doc["schema"] == 1
    assert doc["summary"]["n_findings"] == len(report.findings)
    (kr,) = doc["kernels"]
    assert kr["kernel"] == "planted_race"
    assert {f["kind"] for f in kr["findings"]} == {"shared-race"}
    json.dumps(doc)  # serializable


def test_finding_and_verdict_str():
    f = Finding(kind="shared-race", kernel="k", buffer="s", stage=2,
                detail="boom", suggestion="fix it")
    assert "[shared-race] k stage 2 / s: boom" in str(f)
    v = FusionVerdict(kernel="k", pair=(0, 1), mergeable=True, reason="ok")
    assert "mergeable" in str(v)


# --- the CLI gate ------------------------------------------------------------
def _run_cli(*flags):
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.core.analyze", *flags],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_cli_clean_suite_exits_zero(tmp_path):
    out = tmp_path / "report.json"
    res = _run_cli("--device", CPU, "--json", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "kernelcheck: OK (26 kernels clean; 8/92 stage pairs" in \
        res.stdout
    for name in ("softmax_row", "srad_stats", "srad_update"):
        assert f"kernelcheck {name}: clean" in res.stdout
    doc = json.loads(out.read_text())
    assert doc["summary"]["n_findings"] == 0
    assert doc["summary"]["n_kernels"] == 26


@pytest.mark.parametrize("name,kind", [
    ("race", "shared-race"), ("undeclared-read", "undeclared-read"),
    ("bad-combine", "combine-mismatch")])
def test_cli_injected_bug_trips_gate(name, kind):
    res = _run_cli("--kernels", "vecadd", f"--inject-{name}",
                   "--device", CPU)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "kernelcheck: FAILED" in res.stdout
    assert kind in res.stdout


def test_cli_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    res = _run_cli("--kernels", "vecadd")
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr


# --- the fusion artifact (kernelcheck-fusion-1): schema + CLI ----------------
def test_fusion_artifact_schema():
    """The documented stable schema core/optimize.py and tools consume."""
    entry = next(e for e in SUITE if e.name == "pixel_pipeline")
    (art,) = analyze.fusion_entry(entry, device=CPU)
    assert art["schema"] == analyze.FUSION_SCHEMA == "kernelcheck-fusion-1"
    assert art["kernel"] == "pixel_pipeline"
    assert art["n_stages"] == 3
    for v in art["verdicts"]:
        assert set(v) == {"kernel", "pair", "mergeable", "reason"}
        assert v["kernel"] == "pixel_pipeline"
        i, j = v["pair"]
        assert 0 <= i < j < art["n_stages"]
        assert isinstance(v["mergeable"], bool)
        assert isinstance(v["reason"], str) and v["reason"]
    pairs = {tuple(v["pair"]) for v in art["verdicts"]}
    # all adjacents, plus the skip pair of the maximal mergeable run
    assert {(0, 1), (1, 2), (0, 2)} <= pairs
    for name, facts in art["shared"].items():
        assert name in entry.kernel.shared
        assert set(facts) == {"stages", "last_stage", "private"}
    json.dumps(art)  # serializable as-is


def test_fusion_cli_json(tmp_path):
    out = tmp_path / "fusion.json"
    res = _run_cli("--fusion-only", "--kernels",
                   "pixel_pipeline,reduce_shared", "--json", str(out),
                   "--device", CPU)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "fusion pixel_pipeline: 2/2 adjacent pairs mergeable" in res.stdout
    doc = json.loads(out.read_text())
    assert doc["schema"] == "kernelcheck-fusion-1"
    assert doc["summary"]["n_kernels"] == 2
    by_kernel = {a["kernel"]: a for a in doc["kernels"]}
    assert set(by_kernel) == {"pixel_pipeline", "reduce_shared"}
    # reduce_shared's barrier tree must stay unfused in the artifact too
    assert not any(v["mergeable"]
                   for v in by_kernel["reduce_shared"]["verdicts"])


def test_unknown_suite_entry_raises():
    with pytest.raises(ValueError, match="unknown suite entries"):
        analyze.analyze_suite(names=["nope"], device=CPU)
