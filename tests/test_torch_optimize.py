"""The barrier-fission optimizer in the port (``repro_torch.core.optimize``):
proofs in, rewrites out.

The structure of ``tests/test_optimize.py``, on the port and on the CPU.
Four contracts: (1) optimized runs are **bit-identical** to unoptimized
ones for every suite entry on both stage lowerings - fusion composes stage
functions unchanged, so any bit drift means an unproven dependence
slipped through (the chains' ``loop`` cells, which take most of the time,
are ``tests/test_torch_optimize_chains.py``); (2) the pass fuses the pairs
kernelcheck proves mergeable; (3) optimized and unoptimized
specializations never share a cache entry; (4) the pass *refuses*
hand-crafted plans that ask for fusions the verdicts do not prove.  On
``cuda`` the derived kernel keeps the base's hand-written kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import analyze, api, cuda_suite, index, optimize  # noqa: E402
from repro_torch.core.cuda_suite import run_entry  # noqa: E402
from repro_torch.core.kernel import KernelDef  # noqa: E402
from repro_torch.core.memory import host_array  # noqa: E402
from repro_torch.core.optimize import (  # noqa: E402
    OptimizeError,
    OptPlan,
    OptimizedKernel,
    apply_plan,
    optimize_launch,
    plan_from_artifact,
)

CPU = "cpu"
SUITE = cuda_suite.build_suite(scale=1)
SINGLE = [e for e in SUITE if e.chain is None]


def _entry(name: str):
    return next(e for e in SUITE if e.name == name)


@pytest.fixture(scope="module")
def artifacts():
    """Every suite kernel's fusion artifact, analyzed once."""
    return {a["kernel"]: a for a in analyze.fusion_suite(device=CPU)}


def _args(entry, seed=0):
    return {k: torch.as_tensor(v)
            for k, v in entry.make_args(np.random.default_rng(seed)).items()}


def assert_optimized_bits_identical(entry, backend):
    base, _ = run_entry(entry, backend, rng=np.random.default_rng(3),
                        with_reference=False, device=CPU)
    opt, _ = run_entry(entry, backend, rng=np.random.default_rng(3),
                       with_reference=False, device=CPU, optimize=True)
    assert set(base) == set(opt)
    for k in base:
        assert (host_array(getattr(base[k], "value", base[k])).tobytes()
                == host_array(getattr(opt[k], "value", opt[k])).tobytes()), (
            f"{entry.name}/{backend}: buffer {k!r} drifted under optimize")


# --- bit-identity: the whole suite on vector, the single launches on loop ----
@pytest.mark.parametrize("entry", SUITE, ids=lambda e: e.name)
def test_optimized_bits_identical_vector(entry):
    assert_optimized_bits_identical(entry, "vector")


@pytest.mark.parametrize("entry", SINGLE, ids=lambda e: e.name)
def test_optimized_bits_identical_loop(entry):
    assert_optimized_bits_identical(entry, "loop")


# --- fusion-count floor ------------------------------------------------------
def test_suite_fusion_floor(artifacts):
    """The eight pairs kernelcheck proves, pixel_pipeline's whole-kernel
    region among them."""
    pairs = {k: plan_from_artifact(a).n_fused_pairs
             for k, a in artifacts.items()}
    assert sum(pairs.values()) == 8
    assert pairs["matmul_tiled"] == 2      # (0,1) and (8,9)
    # scan_block keeps only (14,15): the d-th write's masked lanes add a
    # structural 0.0, but a sample-based proof cannot distinguish that
    # from a data-dependent no-op (the nn argmin tree), so the sound
    # attempted-write footprint rejects the (13,15) skip region
    assert pairs["scan_block"] == 1
    assert pairs["lud_diag"] == 1
    assert pairs["pixel_pipeline"] == 2    # 3 stages -> 1
    assert pairs["lavamd"] == 2            # init+first load, compute+store


def test_softmax_row_and_srad_plans(artifacts):
    """The reference cannot analyze these two under this JAX; the port's
    plans: softmax_row fuses nothing but drops its reduction buffer after
    stage 1; srad_step's two kernels give trivial plans."""
    plan = plan_from_artifact(artifacts["softmax_row"])
    assert plan.regions == () and plan.drop_shared == ((1, ("s",)),)
    for name in ("srad_stats", "srad_update"):
        assert plan_from_artifact(artifacts[name]).trivial


def test_plan_stage_counts_and_scalarization(artifacts):
    for name, before, after in (("matmul_tiled", 10, 8),
                                ("scan_block", 16, 15),
                                ("pixel_pipeline", 3, 1)):
        entry = _entry(name)
        art = artifacts[name]
        derived = apply_plan(entry.kernel, plan_from_artifact(art), art)
        assert len(entry.kernel.stages) == before
        assert len(derived.stages) == after, name
    # pixel_pipeline's scratch is single-writer and region-local: the one
    # suite kernel whose shared cell fully scalarizes
    assert plan_from_artifact(artifacts["pixel_pipeline"]).scalarized == (
        "buf",)


def test_identity_plan_returns_base_kernel():
    entry = _entry("vecadd")        # one stage: nothing to fuse or drop
    derived = optimize_launch(entry.kernel, grid=entry.grid,
                              block=entry.block, args=_args(entry))
    assert derived is entry.kernel


def test_optimize_launch_memoizes_derived_kernel():
    entry = _entry("pixel_pipeline")
    kw = dict(grid=entry.grid, block=entry.block, args=_args(entry))
    first = optimize_launch(entry.kernel, **kw)
    assert isinstance(first, OptimizedKernel)
    assert optimize_launch(entry.kernel, **kw) is first
    # an OptimizedKernel passes through untouched (no double-optimize)
    assert optimize_launch(first, **kw) is first


@pytest.mark.parametrize("mode", ["host", "device", "graph"])
def test_run_entry_optimizes_every_launch_in_every_chain_mode(mode):
    """``run_entry(optimize=True)`` reaches each chain step's launch:
    pathfinder's kernel gets its (trivial) plan memoized, and the bits
    are the unoptimized run's."""
    entry = cuda_suite.entry_pathfinder()
    base, _ = run_entry(entry, "vector", with_reference=False, device=CPU,
                        chain_mode=mode)
    assert not getattr(entry.kernel, "_optimize_derived", {})
    opt, _ = run_entry(entry, "vector", with_reference=False, device=CPU,
                       chain_mode=mode, optimize=True)
    assert list(entry.kernel._optimize_derived.values()) == [entry.kernel]
    for k in base:
        assert torch.equal(opt[k], base[k]), k


# --- the lowerings honour drop_shared ----------------------------------------
def _dead_after_first():
    """Stage 0 uses ``s``; stage 1, which reads another thread's ``y``
    (so the barrier stays), records whether ``s`` is still carried."""
    def use(ctx, st):
        s = index.put(st.shared["s"], ctx.tid, 1.0)
        return st.set_shared(s=s).set_glob(
            y=index.put(st.glob["y"], ctx.tid, index.take(s, ctx.tid)))

    def probe(ctx, st):
        flag = torch.full_like(ctx.tid, int("s" in st.shared))
        mirror = index.take(st.glob["y"], 31 - ctx.tid)
        return st.set_glob(c=index.put(st.glob["c"], ctx.tid, flag),
                           z=index.put(st.glob["z"], ctx.tid, mirror))

    return KernelDef("dead_after_first", (use, probe),
                     writes=("y", "c", "z"), reads=("y", "c", "z"),
                     shared={"s": ((32,), torch.float32)})


@pytest.mark.parametrize("backend", ["loop", "vector"])
def test_lowerings_drop_dead_shared_buffers(backend):
    k = _dead_after_first()
    args = {"y": torch.zeros(32), "c": torch.zeros(32, dtype=torch.int32),
            "z": torch.zeros(32)}
    art = analyze.analyze_fusion(k, grid=1, block=32, args=args)
    plan = plan_from_artifact(art)
    assert plan.regions == () and plan.drop_shared == ((0, ("s",)),)
    derived = apply_plan(k, plan, art)
    base = api.launch(k, grid=1, block=32, args=args, backend=backend)
    opt = api.launch(derived, grid=1, block=32, args=args, backend=backend)
    assert base["c"].tolist() == [1] * 32       # the base carries s on
    assert opt["c"].tolist() == [0] * 32        # the derived one drops it
    assert torch.equal(base["z"], opt["z"]) and base["z"].sum() == 32


# --- cuda keeps the hand-written kernel --------------------------------------
def test_derived_kernel_keeps_the_native_descriptor(artifacts):
    for name in ("matmul_tiled", "pixel_pipeline", "lavamd"):
        entry = _entry(name)
        derived = apply_plan(entry.kernel, plan_from_artifact(
            artifacts[name]), artifacts[name])
        assert derived.native == entry.kernel.native is not None


@pytest.mark.parametrize("name", ["matmul_tiled", "pixel_pipeline",
                                  "lud_diag", "softmax_row"])
def test_cuda_under_optimize_gives_the_base_bits(name):
    """On the CPU the cuda backend's wrappers run their plain versions;
    the derived kernel reaches the same wrapper and the same bits."""
    assert_optimized_bits_identical(_entry(name), "cuda")


# --- cache-key separation ----------------------------------------------------
def test_cache_key_separation():
    entry = _entry("pixel_pipeline")
    args = _args(entry)
    derived = optimize_launch(entry.kernel, grid=entry.grid,
                              block=entry.block, args=args)
    assert derived.fingerprint() != entry.kernel.fingerprint()

    api.cache_clear()
    kw = dict(grid=entry.grid, block=entry.block, args=args, backend="loop")
    api.compiled(entry.kernel, **kw)
    n_base = api.cache_size()
    api.compiled(entry.kernel, optimize=True, **kw)
    assert api.cache_size() == n_base + 1   # new specialization, no reuse
    stats = api.cache_stats()
    assert stats.misses >= 2
    # both warm now: repeat lookups hit their own entries
    api.compiled(entry.kernel, **kw)
    api.compiled(entry.kernel, optimize=True, **kw)
    assert api.cache_stats().hits >= stats.hits + 2


# --- refusal: plans the verdicts do not prove --------------------------------
def test_refuses_unproven_fusion_pair(artifacts):
    """reduce_shared's tree levels read other threads' slots: unfusable."""
    entry = _entry("reduce_shared")
    art = artifacts["reduce_shared"]
    assert not any(v["mergeable"] for v in art["verdicts"])
    planted = OptPlan(kernel=entry.kernel.name,
                      n_stages=len(entry.kernel.stages),
                      regions=((0, 1),))
    with pytest.raises(OptimizeError, match="unfusable"):
        apply_plan(entry.kernel, planted, art)


def test_refuses_region_without_skip_proof(artifacts):
    """A 3-stage region needs every intra-region pair, not just adjacents."""
    entry = _entry("reduce_shared")
    planted = OptPlan(kernel=entry.kernel.name,
                      n_stages=len(entry.kernel.stages),
                      regions=((0, 2),))
    with pytest.raises(OptimizeError):
        apply_plan(entry.kernel, planted, artifacts["reduce_shared"])


def test_refuses_unproven_shared_drop(artifacts):
    entry = _entry("pixel_pipeline")
    planted = OptPlan(kernel=entry.kernel.name, n_stages=3,
                      drop_shared=((0, ("buf",)),))   # live through stage 2
    with pytest.raises(OptimizeError, match="live"):
        apply_plan(entry.kernel, planted, artifacts["pixel_pipeline"])


def test_refuses_stage_count_mismatch(artifacts):
    entry = _entry("pixel_pipeline")
    planted = OptPlan(kernel=entry.kernel.name, n_stages=4,
                      regions=((0, 1),))
    with pytest.raises(OptimizeError, match="stage-count"):
        apply_plan(entry.kernel, planted, artifacts["pixel_pipeline"])


def test_refuses_another_schema(artifacts):
    art = dict(artifacts["pixel_pipeline"], schema="kernelcheck-fusion-0")
    with pytest.raises(OptimizeError, match="schema"):
        plan_from_artifact(art)


# --- opt-in surfaces ---------------------------------------------------------
def test_env_flag(monkeypatch):
    monkeypatch.delenv("CUPBOP_OPTIMIZE", raising=False)
    assert not optimize.optimize_env_enabled()
    monkeypatch.setenv("CUPBOP_OPTIMIZE", "0")
    assert not optimize.optimize_env_enabled()
    monkeypatch.setenv("CUPBOP_OPTIMIZE", "1")
    assert optimize.optimize_env_enabled()


def test_env_flag_drives_launch(monkeypatch):
    entry = _entry("pixel_pipeline")
    base, _ = run_entry(entry, "loop", rng=np.random.default_rng(5),
                        with_reference=False, device=CPU)
    monkeypatch.setenv("CUPBOP_OPTIMIZE", "1")
    kernel = cuda_suite.make_pixel_pipeline(4096, 128)   # fresh: no memo attr yet
    out = api.launch(kernel, grid=entry.grid, block=entry.block,
                     args=_args(entry, 5), backend="loop")
    derived = getattr(kernel, "_optimize_derived", {})
    assert any(isinstance(k, OptimizedKernel) for k in derived.values())
    assert torch.equal(out["out"], base["out"])


def test_explicit_false_overrides_env(monkeypatch):
    monkeypatch.setenv("CUPBOP_OPTIMIZE", "1")
    kernel = cuda_suite.make_pixel_pipeline(4096, 128)
    entry = _entry("pixel_pipeline")
    api.launch(kernel, grid=entry.grid, block=entry.block,
               args=_args(entry, 5), backend="loop", optimize=False)
    kernel[entry.grid, entry.block].on(backend="loop", optimize=False)(
        _args(entry, 5))
    assert not getattr(kernel, "_optimize_derived", {})
