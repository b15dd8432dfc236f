"""kernelcheck and the barrier-fission optimizer: the port against the
reference, on the CPU.

* On the 21 suite entries whose analysis the reference runs under this
  JAX, both packages analyze the entry on the inputs of
  ``np.random.default_rng(0)`` (each draws them from its own
  ``make_args``): ``report_to_json`` of the reports, every
  ``fusion_entry`` artifact and the plan made from it must be equal -
  eight fused pairs in all (matmul_tiled 2, scan_block 1, pixel_pipeline
  2, lud_diag 1, lavamd 2).
* ``tests/test_analyze.py``'s test kernels, written once in each package's
  idiom, must give the same findings (kind, location and text) and the
  same fusion verdicts.
* softmax_row and srad_step are the two entries whose analysis the
  reference cannot run under this JAX (``CAVEAT``, ROADMAP "Reference
  caveats"): a stage hands a traced buffer to ``jnp`` through
  ``__jax_array__``, which JAX 0.9 refuses.  The port's analyzer runs
  them; they are held by their clean reports, by plans that agree with
  the access pattern the reference's own stages show, and by their
  ``optimized`` bits on ``vector`` and ``loop``.  Should the reference's
  analysis run again, they are compared like the others.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analyze as janalyze
from repro.core import cuda_suite as jsuite
from repro.core import optimize as joptimize
from repro.core.kernel import KernelDef as JKernelDef
from repro_torch.core import analyze, cuda_suite, index, optimize
from repro_torch.core.kernel import KernelDef
from test_torch_optimize import assert_optimized_bits_identical

CPU = "cpu"
JSUITE = {e.name: e for e in jsuite.build_suite(scale=1)}
SUITE = {e.name: e for e in cuda_suite.build_suite(scale=1)}
#: entries the reference's analyzer cannot run under this JAX, and why
CAVEAT = {
    "softmax_row": "__jax_array__ refused during abstractification (JAX 0.9)",
    "srad_step": "__jax_array__ refused during abstractification (JAX 0.9)",
}
WORKING = [n for n in SUITE if n not in CAVEAT]


def _plan(plan) -> dict:
    return dataclasses.asdict(plan)


@pytest.fixture(scope="module")
def both():
    """name -> (reference's, port's) (report JSON, artifacts), once."""
    out = {}
    for name in WORKING:
        out[name] = (
            (janalyze.report_to_json(janalyze.analyze_entry(JSUITE[name])),
             janalyze.fusion_entry(JSUITE[name])),
            (analyze.report_to_json(analyze.analyze_entry(SUITE[name],
                                                          device=CPU)),
             analyze.fusion_entry(SUITE[name], device=CPU)))
    return out


@pytest.mark.parametrize("name", WORKING)
def test_reports_artifacts_and_plans_equal_the_reference(both, name):
    (jrep, jarts), (rep, arts) = both[name]
    assert rep == jrep
    assert rep["summary"]["n_findings"] == 0
    assert arts == jarts
    for art, jart in zip(arts, jarts, strict=True):
        assert _plan(optimize.plan_from_artifact(art)) == _plan(
            joptimize.plan_from_artifact(jart))


def test_the_fused_pairs_are_the_references_eight(both):
    pairs = {}
    for name, (_, (_, arts)) in both.items():
        for art in arts:
            n = optimize.plan_from_artifact(art).n_fused_pairs
            if n:
                pairs[art["kernel"]] = n
    assert pairs == {"matmul_tiled": 2, "scan_block": 1,
                     "pixel_pipeline": 2, "lud_diag": 1, "lavamd": 2}


# --- the reference's test kernels, in both idioms ----------------------------
def _ww(jax):
    if jax:
        def clash(ctx, st):
            return st.set_shared(s=st.shared["s"].at[
                jnp.zeros_like(ctx.tid)].set(ctx.tid + 1))

        def store(ctx, st):
            return st.set_glob(out=st.glob["out"].at[ctx.tid].set(
                st.shared["s"][0]))
    else:
        def clash(ctx, st):
            return st.set_shared(s=index.put(
                st.shared["s"], torch.zeros_like(ctx.tid), ctx.tid + 1))

        def store(ctx, st):
            return st.set_glob(out=index.put(
                st.glob["out"], ctx.tid, index.take(st.shared["s"], 0)))
    return (clash, store), dict(writes=("out",), reads=("out",),
                                shared={"s": ((4,), "int32")}), \
        1, 8, {"out": np.zeros(8, np.int32)}


def _masked(jax):
    if jax:
        def seed(ctx, st):
            return st.set_shared(s=st.shared["s"].at[ctx.tid].set(
                st.glob["x"][ctx.tid]))

        def level(ctx, st):
            s = st.shared["s"]
            v = jnp.where(ctx.tid < 4,
                          s[ctx.tid] + s[jnp.minimum(ctx.tid + 4, 7)],
                          s[ctx.tid])
            return st.set_shared(s=s.at[ctx.tid].set(v))

        def store(ctx, st):
            return st.set_glob(out=st.glob["out"].at[ctx.tid].set(
                st.shared["s"][ctx.tid]))
    else:
        def seed(ctx, st):
            return st.set_shared(s=index.put(
                st.shared["s"], ctx.tid, index.take(st.glob["x"], ctx.tid)))

        def level(ctx, st):
            s = st.shared["s"]
            v = torch.where(ctx.tid < 4,
                            index.take(s, ctx.tid)
                            + index.take(s, torch.clamp(ctx.tid + 4, max=7)),
                            index.take(s, ctx.tid))
            return st.set_shared(s=index.put(s, ctx.tid, v))

        def store(ctx, st):
            return st.set_glob(out=index.put(
                st.glob["out"], ctx.tid, index.take(st.shared["s"], ctx.tid)))
    return (seed, level, store), dict(writes=("out",), reads=("x", "out"),
                                      shared={"s": ((8,), "float32")}), \
        1, 8, {"x": np.arange(8, dtype=np.float32),
               "out": np.zeros(8, np.float32)}


def _drift(jax):
    if jax:
        def stage(ctx, st):
            return st.set_glob(
                out=st.glob["out"].at[ctx.tid].set(ctx.tid * 2),
                extra=st.glob["extra"].at[ctx.tid].set(ctx.tid))
    else:
        def stage(ctx, st):
            return st.set_glob(
                out=index.put(st.glob["out"], ctx.tid, ctx.tid * 2),
                extra=index.put(st.glob["extra"], ctx.tid, ctx.tid))
    return (stage,), dict(writes=("out",), reads=("out", "ghost")), 1, 16, \
        {"out": np.zeros(16, np.int32), "extra": np.zeros(16, np.int32),
         "ghost": np.zeros(4, np.int32)}


def _noreads(jax):
    if jax:
        def stage(ctx, st):
            return st.set_glob(out=st.glob["out"].at[ctx.tid].set(
                st.glob["x"][ctx.tid]))
    else:
        def stage(ctx, st):
            return st.set_glob(out=index.put(
                st.glob["out"], ctx.tid, index.take(st.glob["x"], ctx.tid)))
    return (stage,), dict(writes=("out",)), 1, 8, \
        {"x": np.arange(8, dtype=np.float32), "out": np.zeros(8, np.float32)}


def _oob(drop):
    def make(jax):
        if jax:
            kw = {"mode": "drop"} if drop else {}

            def stage(ctx, st):
                return st.set_glob(out=st.glob["out"].at[ctx.tid * 2].set(
                    1.0, **kw))
        else:
            def stage(ctx, st):
                return st.set_glob(out=index.put(
                    st.glob["out"], ctx.tid * 2, 1.0, drop=drop))
        return (stage,), dict(writes=("out",), reads=("out",)), 1, 8, \
            {"out": np.zeros(8, np.float32)}
    return make


def _hazard(jax):
    if jax:
        def overwrite(ctx, st):
            return st.set_glob(buf=st.glob["buf"].at[ctx.tid].set(
                ctx.tid * 1.0))

        def reread(ctx, st):
            return st.set_glob(out=st.glob["out"].at[ctx.tid].set(
                st.glob["buf"][7 - ctx.tid]))
    else:
        def overwrite(ctx, st):
            return st.set_glob(buf=index.put(st.glob["buf"], ctx.tid,
                                             ctx.tid * 1.0))

        def reread(ctx, st):
            return st.set_glob(out=index.put(
                st.glob["out"], ctx.tid,
                index.take(st.glob["buf"], 7 - ctx.tid)))
    return (overwrite, reread), dict(writes=("buf", "out"),
                                     reads=("buf", "out"),
                                     donates=("buf",)), 1, 8, \
        {"buf": np.ones(8, np.float32), "out": np.zeros(8, np.float32)}


def _partial(jax):
    if jax:
        def stage(ctx, st):
            return st.set_glob(a=st.glob["a"].at[ctx.tid].set(1.0),
                               b=st.glob["b"].at[ctx.tid].set(2.0))
    else:
        def stage(ctx, st):
            return st.set_glob(a=index.put(st.glob["a"], ctx.tid, 1.0),
                               b=index.put(st.glob["b"], ctx.tid, 2.0))
    return (stage,), dict(writes=("a", "b"), reads=("a", "b"),
                          combines={"a": "sum"}), 1, 8, \
        {"a": np.zeros(8, np.float32), "b": np.zeros(8, np.float32)}


def _notconcat(jax):
    if jax:
        def stage(ctx, st):
            return st.set_glob(y=st.glob["y"].at[jnp.zeros_like(ctx.tid)]
                               .set(ctx.tid * 1.0 + ctx.bid, mode="drop"))
    else:
        def stage(ctx, st):
            return st.set_glob(y=index.put(
                st.glob["y"], torch.zeros_like(ctx.tid),
                ctx.tid * 1.0 + ctx.bid))
    return (stage,), dict(writes=("y",), reads=("y",),
                          combines={"y": "concat"}), 4, 8, \
        {"y": np.zeros(4, np.float32)}


def _noop_write(jax):
    if jax:
        def wr(ctx, st):
            return st.set_shared(s=st.shared["s"].at[ctx.tid].set(
                st.glob["x"][ctx.tid]))

        def rd(ctx, st):
            v = st.shared["s"][jnp.minimum(ctx.tid + 1, 3)]
            return st.set_glob(y=st.glob["y"].at[ctx.tid].set(v))
    else:
        def wr(ctx, st):
            return st.set_shared(s=index.put(
                st.shared["s"], ctx.tid, index.take(st.glob["x"], ctx.tid)))

        def rd(ctx, st):
            v = index.take(st.shared["s"], torch.clamp(ctx.tid + 1, max=3))
            return st.set_glob(y=index.put(st.glob["y"], ctx.tid, v))
    return (wr, rd), dict(writes=("y",), reads=("x", "y"),
                          shared={"s": ((4,), "float32")}), 1, 4, \
        {"x": np.zeros(4, np.float32), "y": np.zeros(4, np.float32)}


TEST_KERNELS = {"ww": _ww, "masked": _masked, "drift": _drift,
                "noreads": _noreads, "oob": _oob(False),
                "oob_ok": _oob(True), "hazard": _hazard,
                "partial": _partial, "notconcat": _notconcat,
                "noop_write": _noop_write}


def _build(name, jax):
    stages, decl, grid, block, args = TEST_KERNELS[name](jax)
    if "shared" in decl:
        lib = jnp if jax else torch
        decl = dict(decl, shared={n: (shape, getattr(lib, dt)) for n, (
            shape, dt) in decl["shared"].items()})
    if jax:
        return (JKernelDef(name, stages, **decl), grid, block,
                {n: jnp.asarray(v) for n, v in args.items()})
    return (KernelDef(name, stages, **decl), grid, block,
            {n: torch.from_numpy(v) for n, v in args.items()})


def _texts(report):
    return ([str(f) for f in report.findings],
            [str(v) for v in report.fusion])


@pytest.mark.parametrize("name", TEST_KERNELS)
def test_test_kernels_give_the_reference_findings(name):
    jk, grid, block, jargs = _build(name, jax=True)
    k, _, _, args = _build(name, jax=False)
    jrep = janalyze.analyze_kernel(jk, grid=grid, block=block, args=jargs)
    rep = analyze.analyze_kernel(k, grid=grid, block=block, args=args)
    assert _texts(rep) == _texts(jrep)
    assert janalyze.analyze_fusion(jk, grid=grid, block=block,
                                   args=jargs) == analyze.analyze_fusion(
        k, grid=grid, block=block, args=args)


@pytest.mark.parametrize("fixture", ["planted_race",
                                     "planted_undeclared_read",
                                     "planted_bad_combine"])
def test_planted_fixtures_give_the_reference_findings(fixture):
    jk, jgrid, jblock, jargs = getattr(janalyze, fixture)()
    k, grid, block, args = getattr(analyze, fixture)()
    assert (grid, block) == (jgrid, jblock)
    for n, v in args.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jargs[n]))
    jrep = janalyze.analyze_kernel(jk, grid=grid, block=block, args=jargs)
    rep = analyze.analyze_kernel(k, grid=grid, block=block, args=args)
    assert _texts(rep) == _texts(jrep) and rep.findings


# --- the reference caveats ---------------------------------------------------
def _reference_analysis(name):
    """The reference's (reports, artifacts), or None where its analyzer
    raises the caveat's error."""
    try:
        return (janalyze.report_to_json(janalyze.analyze_entry(JSUITE[name])),
                janalyze.fusion_entry(JSUITE[name]))
    except ValueError as e:
        assert "__jax_array__" in str(e), e
        return None


@pytest.mark.parametrize("name", sorted(CAVEAT))
def test_caveat_entries_are_clean_and_compared_where_they_can_be(name):
    rep = analyze.report_to_json(analyze.analyze_entry(SUITE[name],
                                                       device=CPU))
    arts = analyze.fusion_entry(SUITE[name], device=CPU)
    assert rep["summary"]["n_findings"] == 0, CAVEAT[name]
    ref = _reference_analysis(name)
    if ref is not None:
        assert (rep, arts) == ref
    plans = {a["kernel"]: optimize.plan_from_artifact(a) for a in arts}
    if name == "softmax_row":
        # three stages, each reading the row's shared scratch another
        # thread wrote: nothing fuses; ``s`` is dead after stage 1
        (plan,) = plans.values()
        assert plan.n_stages == 3 and plan.regions == ()
        assert plan.drop_shared == ((1, ("s",)),)
    else:
        # the stats kernel's barrier tree and the one-stage update
        assert set(plans) == {"srad_stats", "srad_update"}
        assert all(p.trivial for p in plans.values())


@pytest.mark.parametrize("backend", ["vector", "loop"])
def test_caveat_softmax_row_optimized_bits(backend):
    """softmax_row's optimized bits (srad_step's are in
    ``tests/test_torch_optimize.py`` on vector and
    ``tests/test_torch_optimize_chains.py`` on loop)."""
    assert_optimized_bits_identical(SUITE["softmax_row"], backend)
