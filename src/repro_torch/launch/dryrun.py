"""Multi-pod dry run: show that every (arch x shape x mesh) cell runs
sharded, fits, and give its roofline terms, as ``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--out build/repro_torch/dryrun]

A cell runs its train step, prefill or decode step on meta tensors (shape
and dtype, nothing allocated or computed), its parameters, optimizer
state, batch and cache DTensors split over the 256 or 512 ranks of a fake
world (``torch.distributed``'s ``fake`` backend: one process plays rank 0
and every collective returns at once).  One device's local ops are
counted by ``launch.hlo_analysis``.  Per cell the JSON has:

  memory           one device's argument, output and temp bytes and their
                   peak (live storages followed through the meta run)
  cost             one device's FLOPs, bytes and collective link bytes
  roofline         the three terms in seconds, the dominant one, the MFU
                   bound
  replicated_work  devices x one device's FLOPs / the FLOPs of the same
                   step on one device: how much compute DTensor left
                   unpartitioned (1.0 is a perfect split)
  reshards         each view the sharded step could not keep split, and
                   how often it gathered instead (``sharding.RESHARDS``)

The peaks are the card's datasheet figures for an H100 SXM5 80GB at 700 W
(derived numbers, not measurements): bf16 dense 989.4e12 FLOP/s, HBM3
3.35e12 B/s, NVLink 4 450e9 B/s a direction.  A 256-rank mesh crosses
nodes over InfiniBand, which the one link figure does not model.

A train cell of ``m`` microbatches traces one microbatch's forward and
backward and scales its costs by ``m``, then traces the update once: eager
runs the microbatch loop in Python, and every trip costs the same.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

#: datasheet peaks of an H100 SXM5 80GB at 700 W
PEAK_FLOPS = 989.4e12        # bf16 dense FLOP/s per device
HBM_BW = 3.35e12             # HBM3 B/s per device
LINK_BW = 450e9              # NVLink 4 B/s a direction per device
ICI_BW = LINK_BW             # the reference's name for the link figure
HBM_GB = 80.0

#: where the sweep's JSON goes (never the reference's experiments/dryrun)
DEFAULT_OUT = os.path.join("build", "repro_torch", "dryrun")

ACT_BUDGET = int(float(os.environ.get("REPRO_ACT_BUDGET_GB", "3"))
                 * 2**30)   # per-device bytes allowed for the residual carry


def fake_world(world_size: int = 512) -> None:
    """Start the fake process group of ``world_size`` ranks (this process
    rank 0).  It must come before any other distributed call, as the
    reference sets ``XLA_FLAGS`` before JAX starts."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already up; the dry run needs {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _shapes():
    from repro_torch.configs.registry import SHAPES
    return SHAPES


def model_flops_per_chip(cfg, shape_name, n_chips):
    """Strict assignment metric: 6*N*D (train) / 2*N*D (inference)."""
    sh = _shapes()[shape_name]
    tokens = sh["global_batch"] * (sh["seq_len"] if sh["kind"] != "decode"
                                   else 1)
    n_active = cfg.param_count(active_only=True)
    mult = 6 if sh["kind"] == "train" else 2
    return mult * n_active * tokens / n_chips


def attn_adjusted_model_flops_per_chip(cfg, shape_name, n_chips):
    """6ND plus the intrinsic attention/state-mixing matmuls (PaLM-style MFU
    accounting, unpadded head counts) - the 'achievable useful flops'."""
    sh = _shapes()[shape_name]
    S = sh["seq_len"]
    decode = sh["kind"] == "decode"
    tokens = sh["global_batch"] * (1 if decode else S)
    fb = 2 if decode else (6 if sh["kind"] == "train" else 2)
    mix_fwd_per_tok = 0.0
    if cfg.rwkv is not None:
        H, hd = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
        mix_fwd_per_tok = 4.0 * H * hd * hd * cfg.num_layers
    elif cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        H = d_inner // s.head_dim
        mix_fwd_per_tok = (2.0 * H * s.head_dim * (2 * s.state_dim
                                                   + s.chunk / 2)
                           * cfg.num_layers)
        if cfg.attn_every:
            ctx = S if decode else S / 2
            napps = -(-cfg.num_layers // cfg.attn_every)
            mix_fwd_per_tok += (4.0 * cfg.num_heads * cfg.hd * ctx * napps)
    else:
        ctx = S if decode else S / 2
        mix_fwd_per_tok = 4.0 * cfg.num_heads * cfg.hd * ctx * cfg.num_layers
    base = model_flops_per_chip(cfg, shape_name, n_chips)
    return base + (fb / 2.0) * mix_fwd_per_tok * tokens / n_chips


def pick_microbatches(cfg, shape_name, mesh) -> int:
    """Gradient-accumulation factor so the residual carried between layers
    fits: ``(B_chip / mb) * S * D * 2B * L`` under ``ACT_BUDGET``, the
    smallest power of two."""
    from repro_torch.distributed.sharding import axis_sizes
    sh = _shapes()[shape_name]
    if sh["kind"] != "train":
        return 1
    sizes = axis_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    b_chip = max(1, sh["global_batch"] // dp)
    carry = b_chip * sh["seq_len"] * cfg.d_model * 2 * cfg.num_layers
    if cfg.seq_parallel and sh["seq_len"] % sizes.get("model", 1) == 0:
        carry //= sizes.get("model", 1)   # SP shards the residual carry
    mb = 1
    while carry / mb > ACT_BUDGET and mb < b_chip:
        mb *= 2
    return mb


def _on_mesh(t, mesh, pl):
    """A meta tensor as a DTensor of placements ``pl``: each device's
    local shard a meta tensor, nothing scattered; on a mesh of one device
    the tensor itself."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import local_shape
    if mesh is None or math.prod(mesh.mesh.shape) == 1:
        return t
    local = local_shape(t.shape, mesh, pl)
    return DTensor.from_local(
        torch.empty(local, dtype=t.dtype, device="meta"), mesh, list(pl),
        run_check=False, shape=t.shape, stride=t.stride())


def _tree_on_mesh(tree, mesh, pls):
    """:func:`_on_mesh` over a tree of meta tensors and its placements."""
    from repro_torch.distributed.sharding import at_path, map_with_path
    return map_with_path(
        lambda path, t: _on_mesh(t, mesh, at_path(pls, path)), tree)


def _local_slice(b, mb: int):
    """Each device's first ``1 / mb`` of its batch rows (a microbatch)."""
    from repro_torch.distributed import sharding as shd
    if mb == 1:
        return b
    return {k: shd.local_call(lambda t: t[: t.shape[0] // mb], v, keep=(0,))
            for k, v in b.items()}


def lower_cell(cfg, shape_name, mesh, serve_pure_tp: bool = False):
    """The cell's phases to trace (the reference's lowering) as ``[(name,
    fn, args, scale)]``, their inputs DTensors on ``mesh`` (plain meta
    tensors when ``mesh`` is None or one device), and the rule overrides
    to trace them under.

    ``serve_pure_tp`` (optimization O2): inference has no optimizer
    states, so weights replicate across 'data' (pure TP) instead of FSDP.
    """
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    sh = _shapes()[shape_name]
    kind = sh["kind"]
    bstruct = specs.input_specs(cfg, shape_name)
    rules = {"fsdp": ()} if (serve_pure_tp and kind != "train") else None

    def put(tree, placements_of):
        """``tree``'s tensors on ``mesh`` by ``placements_of(tree, mesh)``
        (the rule overrides in force)."""
        if mesh is None:
            return tree
        pls = placements_of(tree, mesh)
        return {k: _tree_on_mesh(v, mesh, pls[k]) if k in pls else v
                for k, v in tree.items()}

    with shd.use_mesh(mesh, rules=rules):
        ps = put(T.abstract_params(cfg), shd.param_placements)
        if kind == "train":
            opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)
            o = adamw.init_state(opt_cfg, T.abstract_params(cfg))
            o = adamw.AdamWState(o.step, put(o.m, shd.param_placements),
                                 put(o.v, shd.param_placements))
            mb = pick_microbatches(cfg, shape_name, mesh) if mesh else 1
            return train_phases(cfg, opt_cfg, ps, o,
                                put(bstruct, specs.batch_sharding), mb), rules
        if kind == "prefill":
            def prefill(p, b):
                return T.prefill(cfg, p, b, max_len=sh["seq_len"])
            return [("prefill", prefill,
                     (ps, put(bstruct, specs.batch_sharding)), 1)], rules
        # the step at the cache's last place reads every key, as the
        # reference's step attends over the whole (masked) cache
        cache = dict(bstruct["cache"], pos=sh["seq_len"] - 1)
        toks = put({"tokens": bstruct["tokens"]}, specs.batch_sharding)

        def decode(p, c, t):
            return T.decode_step(cfg, p, c, t["tokens"])
        return [("decode", decode, (ps, put(cache, specs.cache_sharding),
                                    toks), 1)], rules


def train_phases(cfg, opt_cfg, params, opt_state, batch, mb: int = 1):
    """A train step's phases for :func:`run_phases`: one microbatch's
    loss and gradients (``1 / mb`` of each device's rows, its costs
    scaled by ``mb``), then the AdamW update on those gradients."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_mod
    loss = train_mod.make_loss(cfg)

    def grads(p, b):
        return train_mod.value_and_grad(loss, p, _local_slice(b, mb))

    def update(p, g, o):
        return adamw.apply_updates(opt_cfg, p, g, o)
    return [("grads", grads, (params, batch), mb),
            ("update", update, (params, None, opt_state), 1)]


def _local_bytes(tree) -> int:
    from repro_torch.launch.hlo_analysis import _nbytes, _tensors
    return sum(_nbytes(getattr(t, "_local_tensor", t)) for t in _tensors(tree))


def run_phases(phases, mesh, rules, n_chips):
    """Trace the phases in order (the update takes the grads phase's
    gradients); returns (one device's costs, its memory in bytes:
    arguments, outputs, temps, the peak)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import hlo_analysis
    total = hlo_analysis.Costs()
    args_bytes = out_bytes = peak = 0
    grads = None
    with shd.use_mesh(mesh, rules=rules):
        for name, fn, args, scale in phases:
            update = name == "update"
            if update:                # the parameters are counted already
                args = (args[0], grads, args[2])
            out, tracer = hlo_analysis.trace(fn, *args,
                                             num_partitions=n_chips)
            total = total + tracer.costs.scale(scale)
            args_bytes += _local_bytes(args[2] if update else args)
            held = _local_bytes(grads) if update else 0
            peak = max(peak, held + tracer.peak_bytes)
            if name == "grads":
                grads = out[1]
            else:
                out_bytes += _local_bytes(out)
            del out
    return total, {"argument_bytes": args_bytes, "output_bytes": out_bytes,
                   "temp_bytes": max(peak - out_bytes, 0),
                   "alias_bytes": 0, "peak_bytes": args_bytes + peak}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None,
             serve_pure_tp: bool = False, mesh=None) -> dict:
    """One cell's record (module docstring).  ``mesh`` defaults to the
    production mesh of the fake world (:func:`fake_world` first)."""
    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import RESHARDS, axis_sizes
    from repro_torch.launch.mesh import make_production_mesh
    cfg = registry.get(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    sizes = axis_sizes(mesh)
    n_chips = math.prod(sizes.values())
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, sizes.values())),
           "multi_pod": multi_pod, "status": "ok",
           "serve_pure_tp": serve_pure_tp,
           "overrides": {k: str(v) for k, v in (overrides or {}).items()},
           "microbatches": pick_microbatches(cfg, shape_name, mesh),
           "device": "NVIDIA H100 SXM5 80GB, 700 W (datasheet peaks)"}
    t0 = time.time()
    RESHARDS.clear()
    try:
        phases, rules = lower_cell(cfg, shape_name, mesh,
                                   serve_pure_tp=serve_pure_tp)
        rec["lower_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        costs, mem = run_phases(phases, mesh, rules, n_chips)
        rec["trace_s"] = round(time.time() - t1, 2)
        rec["reshards"] = dict(RESHARDS)
        rec["memory"] = {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "peak_per_chip_gb": round(mem["peak_bytes"] / 2**30, 3),
        }
        rec["memory"]["fits_80gb_hbm"] = \
            rec["memory"]["peak_per_chip_gb"] <= HBM_GB
        rec["cost"] = {
            "flops_per_chip": costs.flops,
            "hbm_bytes_per_chip": costs.bytes,
            "coll_link_bytes_per_chip": costs.coll_bytes,
            "coll_counts": dict(costs.coll_counts),
        }
        t2 = time.time()
        one, _ = lower_cell(cfg, shape_name, None)
        one_costs, _ = run_phases(one, None, None, 1)
        rec["one_device_s"] = round(time.time() - t2, 2)
        rec["replicated_work"] = (n_chips * costs.flops
                                  / max(one_costs.flops, 1.0))
        mf = model_flops_per_chip(cfg, shape_name, n_chips)
        mfa = attn_adjusted_model_flops_per_chip(cfg, shape_name, n_chips)
        t_c = costs.flops / PEAK_FLOPS
        t_m = costs.bytes / HBM_BW
        t_x = costs.coll_bytes / LINK_BW
        dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
        rec["roofline"] = {
            "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dom[1],
            "model_flops_per_chip": mf,
            "attn_adj_model_flops_per_chip": mfa,
            "model_over_hlo_flops": mf / max(costs.flops, 1.0),
            "adj_model_over_hlo_flops": mfa / max(costs.flops, 1.0),
            "bound_step_s": max(t_c, t_m, t_x),
            "mfu_bound": mf / PEAK_FLOPS / max(t_c, t_m, t_x),
        }
    except Exception as e:  # broad on purpose: a failed cell is a finding
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def optimized_overrides(arch: str, shape_name: str):
    """The beyond-paper configuration per cell: O1 seq-parallel for train
    cells, O2 pure-TP params for serve cells."""
    kind = _shapes()[shape_name]["kind"]
    overrides = {}
    if kind == "train":
        overrides["seq_parallel"] = True
    return overrides, kind != "train"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the beyond-paper config (O1/O2)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    fake_world(512)
    from repro_torch.configs import registry
    os.makedirs(args.out, exist_ok=True)
    cells = registry.cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    failed = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}" + \
                ("_opt" if args.optimized else "")
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") == "ok":
                        print(f"[skip] {tag}")
                        continue
            if args.optimized:
                ov, tp = optimized_overrides(arch, shape)
                rec = run_cell(arch, shape, mp, overrides=ov,
                               serve_pure_tp=tp)
            else:
                rec = run_cell(arch, shape, mp)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            r = rec.get("roofline", {})
            failed += rec["status"] != "ok"
            print(f"[{rec['status']}] {tag} trace={rec.get('trace_s')}s "
                  f"mem={rec.get('memory', {}).get('peak_per_chip_gb')}GB "
                  f"dom={r.get('dominant')} mfu_bound="
                  f"{r.get('mfu_bound', 0):.3f} replicated_work="
                  f"{rec.get('replicated_work', 0):.3f} reshards="
                  f"{sum(rec.get('reshards', {}).values())}"
                  + ("" if rec["status"] == "ok" else
                     " ERR " + rec.get("error", "")[:160]), flush=True)
    return failed


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
