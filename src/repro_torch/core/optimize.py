"""Barrier-fission optimizer: spend kernelcheck's fusion proofs on speed.

The counterpart of ``repro.core.optimize``.  Every ``__syncthreads`` in a
CUDA kernel becomes a stage boundary in the IR (kernel.py), and both of
the port's stage lowerings pay for it: the loop backend restarts its loop
over thread chunks per stage (re-threading the whole shared dict through
each one), and the vector backend re-checks private-value chunk shapes
per stage.  Polygeist's GPU-to-CPU work (see PAPERS.md) measures exactly
this - barrier handling and missed fusion dominate translated-kernel time
on CPUs.  Most barriers are, however, conservative: kernelcheck
(:mod:`repro_torch.core.analyze`) proves per stage pair whether any
cross-thread dependence actually flows through shared or global memory.

This module is the consumer of those proofs.  Given a kernel and a launch
geometry it:

* **fuses barrier-free regions** - maximal stage runs where *every*
  intra-region pair (adjacent and skip) is proven independent collapse
  into one composed stage, so the ``__syncthreads`` between them
  disappears from both lowerings.  Fusion is pure composition
  (``b(ctx, a(ctx, st))``): the per-thread program is unchanged, only the
  barrier is removed, so results are bit-identical on every backend - the
  conformance matrix's ``optimized`` leg enforces that.
* **drops dead shared carries / scalarizes private cells** - a __shared__
  buffer whose last touching stage is proven is deleted from the carried
  state right after it, so later stage loops stop threading it through.
  A buffer that is single-thread-private and lives entirely inside one
  fused region never crosses a live barrier at all; it is reported as
  ``scalarized``.

The derived kernel keeps the base's :class:`~repro_torch.core.kernel
.Native` descriptor: on the ``cuda`` backend an optimized launch
launches the same hand-written Hopper kernel, which has barriers of its
own design, and gives the base launch's bits.  The transform acts on the
stage lowerings only.

The analysis contract is kernelcheck's: verdicts are established on
sampled blocks under the vector thread model, and buffer *touch* sets are
fixed by the stage code (which buffers a stage indexes does not depend on
the block).  A plan that asks for anything the artifact does not prove is
refused with :class:`OptimizeError` - including every skip pair of a
multi-stage region, because adjacent proofs do not compose.

Entry points: ``launch(..., optimize=True)`` / ``.on(optimize=True)`` /
``CUPBOP_OPTIMIZE=1`` on the api path (memoized per geometry+shapes like
``sanitize=``), or :func:`optimize_kernel` / :func:`apply_plan` directly.
The derived :class:`OptimizedKernel` carries its own fingerprint domain
and its own launch cache, so optimized and unoptimized specializations
never collide.
"""
from __future__ import annotations

import dataclasses
import hashlib

from repro_torch.core import analyze, api
from repro_torch.core.dim3 import Dim3
from repro_torch.core.kernel import KernelDef

__all__ = [
    "OptPlan", "OptimizeError", "OptimizedKernel", "apply_plan",
    "optimize_env_enabled", "optimize_kernel", "optimize_launch",
    "plan_from_artifact",
]


class OptimizeError(Exception):
    """An optimization plan asks for a transform the verdicts don't prove."""


@dataclasses.dataclass(frozen=True)
class OptPlan:
    """A verdict-backed rewrite plan for one kernel at one geometry.

    ``regions`` are inclusive ``(start, end)`` spans of *original* stage
    indices to fuse; ``drop_shared`` maps an original stage index to the
    __shared__ buffers provably dead after it; ``scalarized`` names the
    single-thread-private buffers whose every touching stage lies in one
    fused region (or one stage) - after fusion they never cross a
    barrier, so each cell degenerates to a per-thread value.
    """

    kernel: str
    n_stages: int
    regions: tuple[tuple[int, int], ...] = ()
    drop_shared: tuple[tuple[int, tuple[str, ...]], ...] = ()
    scalarized: tuple[str, ...] = ()

    @property
    def n_fused_pairs(self) -> int:
        """Barriers removed (= adjacent pairs fused)."""
        return sum(e - s for s, e in self.regions)

    @property
    def trivial(self) -> bool:
        return not self.regions and not self.drop_shared


@dataclasses.dataclass(frozen=True, eq=False)
class OptimizedKernel(KernelDef):
    """A :class:`KernelDef` derived by :func:`apply_plan`.

    Same declarations (writes/reads/combines/donates) and the same
    ``native`` kernel as ``base`` - the memory runtime's rebinding and
    donation logic and the ``cuda`` backend see no difference - but fewer
    stages, its own fingerprint domain and, being another object, its own
    launch cache, so an optimized specialization can never be served for
    the base kernel or vice versa.
    """

    base: KernelDef | None = None
    plan: OptPlan | None = None
    # post-fusion stage index -> shared buffers to delete from the carried
    # state after that stage runs; both lowerings honor this
    drop_shared: tuple[tuple[int, tuple[str, ...]], ...] = ()

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        h.update(b"cupbop-optimize-v1\x00")
        h.update(self.base.fingerprint().encode())
        h.update(repr((self.plan.regions, self.plan.scalarized,
                       self.drop_shared)).encode())
        return h.hexdigest()


def _fuse2(a, b):
    """Compose two stages into one barrier-free stage."""
    def fused(ctx, st):
        return b(ctx, a(ctx, st))
    return fused


def _verdict_map(artifact: dict) -> dict:
    if artifact.get("schema") != "kernelcheck-fusion-1":
        raise OptimizeError(
            f"unsupported fusion artifact schema {artifact.get('schema')!r}"
            " (need kernelcheck-fusion-1)")
    out = {}
    for v in artifact["verdicts"]:
        out[tuple(v["pair"])] = (bool(v["mergeable"]), v.get("reason", ""))
    return out


def plan_from_artifact(artifact: dict) -> OptPlan:
    """Greedy maximal-region plan from a ``kernelcheck-fusion-1`` artifact.

    A region grows right only while the next adjacent pair *and* every
    skip pair back to the region start are proven mergeable.  Shared
    buffers with a proven last touching stage before the final stage are
    scheduled for carried-state elision after it; the private-and-
    region-local ones are additionally marked scalarized.
    """
    ok = {p: m for p, (m, _r) in _verdict_map(artifact).items()}
    n = int(artifact["n_stages"])
    regions: list[tuple[int, int]] = []
    i = 0
    while i < n - 1:
        if not ok.get((i, i + 1), False):
            i += 1
            continue
        j = i + 1
        while (j < n - 1 and ok.get((j, j + 1), False)
               and all(ok.get((p, j + 1), False) for p in range(i, j))):
            j += 1
        regions.append((i, j))
        i = j + 1

    covering: dict[int, tuple[int, int]] = {}
    for s, e in regions:
        for k in range(s, e + 1):
            covering[k] = (s, e)

    drops: dict[int, list[str]] = {}
    scalarized: list[str] = []
    for name, facts in sorted(artifact.get("shared", {}).items()):
        stages = list(facts.get("stages") or ())
        last = max(stages) if stages else 0
        if facts.get("private") and stages:
            region = covering.get(stages[0])
            if len(set(stages)) == 1 or (
                    region is not None
                    and all(covering.get(s) == region for s in stages)):
                # single-thread-private and never crossing a barrier after
                # fusion: the cell degenerates to a per-thread value
                scalarized.append(name)
        if stages and last >= n - 1:
            continue  # live into the final stage: nothing to elide
        drops.setdefault(last, []).append(name)

    return OptPlan(
        kernel=artifact["kernel"], n_stages=n, regions=tuple(regions),
        drop_shared=tuple((k, tuple(sorted(v)))
                          for k, v in sorted(drops.items())),
        scalarized=tuple(scalarized))


def _validate_plan(kernel: KernelDef, plan: OptPlan,
                   artifact: dict) -> None:
    """Refuse any transform the artifact does not prove."""
    if plan.kernel != kernel.name:
        raise OptimizeError(
            f"plan is for kernel {plan.kernel!r}, not {kernel.name!r}")
    n = len(kernel.stages)
    if plan.n_stages != n or int(artifact.get("n_stages", -1)) != n:
        raise OptimizeError(
            f"stage-count mismatch for {kernel.name}: kernel has {n}, "
            f"plan says {plan.n_stages}, artifact says "
            f"{artifact.get('n_stages')}")
    verdicts = _verdict_map(artifact)
    prev_end = -1
    for s, e in plan.regions:
        if not (0 <= s < e < n) or s <= prev_end:
            raise OptimizeError(
                f"malformed fusion region ({s}, {e}) for {kernel.name}")
        prev_end = e
        # every intra-region pair must be proven - adjacent AND skip;
        # this is the refusal path for unfusable pairs
        for p in range(s, e + 1):
            for q in range(p + 1, e + 1):
                got = verdicts.get((p, q))
                if got is None:
                    raise OptimizeError(
                        f"cannot fuse stages {p}..{q} of {kernel.name}: "
                        f"no verdict for pair ({p}, {q}) in the artifact")
                mergeable, reason = got
                if not mergeable:
                    raise OptimizeError(
                        f"cannot fuse stages {p}..{q} of {kernel.name}: "
                        f"kernelcheck marks pair ({p}, {q}) unfusable "
                        f"({reason})")
    shared = artifact.get("shared", {})
    declared = set(kernel.shared.keys())
    for stage, names in plan.drop_shared:
        if not 0 <= stage < n:
            raise OptimizeError(
                f"drop_shared stage {stage} out of range for {kernel.name}")
        for name in names:
            if name not in declared:
                raise OptimizeError(
                    f"drop_shared names undeclared buffer {name!r} "
                    f"of {kernel.name}")
            facts = shared.get(name)
            last = (max(facts["stages"]) if facts and facts.get("stages")
                    else 0)
            if facts is None or last > stage:
                raise OptimizeError(
                    f"cannot drop shared buffer {name!r} after stage "
                    f"{stage} of {kernel.name}: artifact proves it live "
                    f"through stage {last if facts else '?'}")
    for name in plan.scalarized:
        if name not in declared:
            raise OptimizeError(
                f"scalarized names undeclared buffer {name!r} "
                f"of {kernel.name}")
        if not (shared.get(name) or {}).get("private"):
            raise OptimizeError(
                f"cannot scalarize shared buffer {name!r} of "
                f"{kernel.name}: artifact does not prove single-thread "
                f"ownership")


def apply_plan(kernel: KernelDef, plan: OptPlan,
               artifact: dict) -> KernelDef:
    """Validate ``plan`` against ``artifact`` and derive the kernel.

    Raises :class:`OptimizeError` for any fusion pair or shared-buffer
    drop the artifact does not prove.  A trivial plan returns ``kernel``
    unchanged (the identity transform shares the base specialization by
    design - there is nothing to separate).
    """
    _validate_plan(kernel, plan, artifact)
    if plan.trivial:
        return kernel

    region_at = {s: (s, e) for s, e in plan.regions}
    new_stages: list = []
    new_index: dict[int, int] = {}
    i = 0
    while i < len(kernel.stages):
        if i in region_at:
            s, e = region_at[i]
            fused = kernel.stages[s]
            for k in range(s + 1, e + 1):
                fused = _fuse2(fused, kernel.stages[k])
            fused.fused_span = (s, e)  # introspection only
            new_stages.append(fused)
            for k in range(s, e + 1):
                new_index[k] = len(new_stages) - 1
            i = e + 1
        else:
            new_stages.append(kernel.stages[i])
            new_index[i] = len(new_stages) - 1
            i += 1

    drop_new: dict[int, list[str]] = {}
    for orig, names in plan.drop_shared:
        drop_new.setdefault(new_index[orig], []).extend(names)

    return OptimizedKernel(
        name=kernel.name, stages=tuple(new_stages), writes=kernel.writes,
        shared=dict(kernel.shared), reads=kernel.reads,
        uses_warp=kernel.uses_warp, est_block_work=kernel.est_block_work,
        combines=dict(kernel.combines), donates=kernel.donates,
        native=kernel.native, base=kernel, plan=plan,
        drop_shared=tuple((k, tuple(sorted(set(v))))
                          for k, v in sorted(drop_new.items())))


def optimize_kernel(kernel: KernelDef, *, grid, block, args: dict,
                    dyn_shared: int | None = None,
                    sample_blocks: int = 3) -> KernelDef:
    """Analyze, plan, and apply in one step (uncached).

    Returns ``kernel`` itself when the verdicts prove nothing worth
    doing, else an :class:`OptimizedKernel`.
    """
    artifact = analyze.analyze_fusion(
        kernel, grid=grid, block=block, args=args, dyn_shared=dyn_shared,
        sample_blocks=sample_blocks)
    plan = plan_from_artifact(artifact)
    return apply_plan(kernel, plan, artifact)


# --------------------------------------------------------------------------
# Launch-path hook: optimize=True / CUPBOP_OPTIMIZE=1.
# --------------------------------------------------------------------------
_OPTIMIZE_ATTR = "_optimize_derived"


def optimize_env_enabled() -> bool:
    return api._optimize_enabled(None)


def optimize_launch(kernel: KernelDef, *, grid, block, args: dict,
                    dyn_shared: int | None = None) -> KernelDef:
    """The memoized launch-path entry: derive (or reuse) per geometry.

    Mirrors ``sanitize_launch``'s lifetime discipline: the derived kernel
    is cached on the base kernel keyed by (geometry, dyn_shared, arg
    shapes), so warm launches and chain replays pay nothing after the
    first analysis.  Already-optimized kernels pass through untouched.
    """
    if isinstance(kernel, OptimizedKernel):
        return kernel
    grid, block = Dim3.of(grid), Dim3.of(block)
    raw = analyze._raw_args(args, "optimize")
    key = analyze._launch_key(grid, block, dyn_shared, raw)
    cache = getattr(kernel, _OPTIMIZE_ATTR, None)
    if cache is None:
        cache = {}
        object.__setattr__(kernel, _OPTIMIZE_ATTR, cache)  # frozen dataclass
    derived = cache.get(key)
    if derived is None:
        derived = optimize_kernel(kernel, grid=grid, block=block,
                                  args=raw, dyn_shared=dyn_shared)
        cache[key] = derived
    return derived
