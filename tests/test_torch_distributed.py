"""The port's sharding rules and gradient compression against the
reference's ``repro.distributed`` on the CPU.

``resolve`` and ``spec_for_path`` give the reference's specs (every leaf
of every arch's parameters on a 16x16 stand-in mesh); ``quantize`` /
``dequantize`` give its bits; ``compressed_psum`` at 4 gloo ranks gives
the reference's 4-device ``shard_map`` result bit for bit.  The ranks and
the reference's forced devices run in child processes, never in the
pytest worker.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _jax():
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.distributed import compression, sharding
    from repro.models import transformer
    return jax, jnp, registry, sharding, compression, transformer


class FakeMesh:
    axis_names = ("pod", "data", "model")
    devices = np.empty((2, 16, 16))


class FakeMesh2:
    axis_names = ("data", "model")
    devices = np.empty((16, 16))


RESOLVE_CASES = [
    ((256, 4096), ("batch", None)),
    ((1, 5), ("batch", None)),
    ((40, 64), ("heads", None)),
    ((48, 64), ("heads", None)),
    ((32, 32), ("heads", "vocab")),
    ((64, 4096, 128), ("batch", "seq_sp", "tp")),
    ((16, 8, 512), ("none", "fsdp", "tp")),
    ((2, 4), ("kv_seq", "expert")),
]


@pytest.mark.parametrize("mesh", [FakeMesh(), FakeMesh2()],
                         ids=["2x16x16", "16x16"])
@pytest.mark.parametrize("shape,logical", RESOLVE_CASES)
def test_resolve_is_the_references(mesh, shape, logical):
    _, _, _, jshd, _, _ = _jax()
    assert tuple(tshd.resolve(mesh, shape, logical)) == \
        tuple(jshd.resolve(mesh, shape, logical))


def test_resolve_divisibility():
    m = FakeMesh()
    spec = tshd.resolve(m, (256, 4096), ("batch", None))
    assert spec == tshd.P(("pod", "data"), None)
    # batch=1 cannot shard
    assert tshd.resolve(m, (1, 5), ("batch", None))[0] is None
    # 40 heads don't divide 16 -> unsharded (padding exists for this)
    assert tshd.resolve(m, (40, 64), ("heads", None))[0] is None
    assert tshd.resolve(m, (48, 64), ("heads", None))[0] == "model"
    # no axis reuse across dims
    spec = tshd.resolve(m, (32, 32), ("heads", "vocab"))
    assert spec[0] == "model" and spec[1] is None


def test_placements_split_pod_and_data_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh()
    spec = tshd.resolve(m, (256, 4096, 48), ("batch", None, "heads"))
    assert tshd.placements(m, spec) == (Shard(0), Shard(0), Shard(2))
    assert tshd.placements(m, tshd.P()) == (Replicate(),) * 3


def test_use_mesh_restores_the_rules():
    before = dict(tshd.RULES)
    with tshd.use_mesh(FakeMesh2(), rules={"fsdp": ()}):
        assert tshd.RULES["fsdp"] == () and tshd.active_mesh() is not None
    assert tshd.RULES == before and tshd.active_mesh() is None


def test_device_type_is_the_card_or_an_error(monkeypatch):
    # the port's rule (core.memory.resolve_device): no device asked for
    # means the card, and without one it raises; "cpu" is honoured
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tshd.device_type()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tshd.device_type("cuda")
    assert tshd.device_type("cpu") == "cpu"
    assert tshd.device_type(torch.device("meta")) == "meta"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tshd.device_type() == "cuda"


def test_constrain_is_the_identity_without_a_dtensor():
    x = torch.ones(4, 4)
    assert tshd.constrain(x, "batch", None) is x
    with tshd.use_mesh(FakeMesh2()):
        assert tshd.constrain(x, "batch", None) is x


def _ref_leaves(jax, tree, jshd):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jshd._path_str(p): leaf for p, leaf in flat}


def _port_leaves(tree):
    out = {}
    tshd.map_with_path(
        lambda p, t: out.__setitem__(tshd._path_str(p), t), tree)
    return out


@pytest.mark.parametrize("arch", list(treg.ARCHS))
def test_spec_for_path_is_the_references_for_every_leaf(arch):
    jax, _, jreg, jshd, _, JT = _jax()
    mesh = FakeMesh2()
    ref = _ref_leaves(jax, JT.abstract_params(jreg.get(arch)), jshd)
    got = _port_leaves(TT.abstract_params(treg.get(arch)))
    assert set(ref) == set(got)
    for name, leaf in got.items():
        want = jshd.spec_for_path(mesh, name, ref[name].shape)
        assert tuple(tshd.spec_for_path(mesh, name, leaf.shape)) == \
            tuple(want), name
    specs = _port_leaves(tshd.param_specs(TT.abstract_params(
        treg.get(arch)), mesh))
    assert all(isinstance(s, tshd.P) for s in specs.values())


def test_param_specs_cover_all_leaves():
    mesh = FakeMesh2()
    sizes = {"data": 16, "model": 16}
    leaves = _port_leaves(TT.abstract_params(treg.get("qwen2.5-32b")))
    big_unsharded = []
    for name, leaf in leaves.items():
        ps = tshd.spec_for_path(mesh, name, leaf.shape)
        for dim, ax in zip(leaf.shape, tuple(ps) + (None,) * 10,
                           strict=False):
            if ax is None:
                continue
            axes = (ax,) if isinstance(ax, str) else ax
            prod = int(np.prod([sizes[a] for a in axes]))
            assert dim % prod == 0, (name, leaf.shape, ps)
        if leaf.numel() > 1_000_000 and all(a is None for a in tuple(ps)):
            big_unsharded.append((name, leaf.shape))
    assert not big_unsharded, f"large replicated params: {big_unsharded}"


# --- gradient compression ----------------------------------------------------
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_quantize_gives_the_references_bits(bits, dtype, scale):
    jax, jnp, _, _, jcomp, _ = _jax()
    g = (np.random.default_rng(3).standard_normal(777).astype(np.float32)
         * scale)
    g[5] = 0.5 * np.abs(g).max() / (2 ** (bits - 1) - 1)   # a half step
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jg = jnp.asarray(g).astype(dtype)
    q, s = tcomp.quantize(tg, bits)
    jq, js = jcomp.quantize(jg, bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    d = tcomp.dequantize(q, s)
    assert d.numpy().tobytes() == np.asarray(
        jcomp.dequantize(jq, js)).tobytes()


def test_quantize_error_bound():
    rng = np.random.default_rng(0)
    for scale in (1e-3, 1.0, 1e3):
        g = torch.from_numpy(rng.standard_normal(512).astype("f") * scale)
        q, s = tcomp.quantize(g)
        err = (tcomp.dequantize(q, s) - g).abs().numpy()
        assert err.max() <= float(s) * 0.5 + 1e-12


def test_dcn_bytes():
    comp, full = tcomp.dcn_bytes({"a": torch.zeros(100)})
    assert comp == 100 and full == 400


# the same seeded inputs on both sides: 4 ranks' gradient trees, two
# steps, the second with the first's error feedback
_INPUTS = """
import numpy as np
def inputs():
    rng = np.random.default_rng(11)
    steps = []
    for _ in range(2):
        steps.append([{"a": rng.standard_normal((8, 16)).astype(np.float32)
                       * 10 ** rng.uniform(-2, 2),
                       "b": rng.standard_normal(33).astype(np.float32)}
                      for _ in range(4)])
    return steps
"""

_REF = _INPUTS + """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.distributed.compression import compressed_psum
from repro.distributed.sharding import make_mesh
mesh = make_mesh((4,), ("pod",))
steps = inputs()

def per_pod(g, e):
    g = {k: v[0] for k, v in g.items()}
    e = None if e is None else {k: v[0] for k, v in e.items()}
    out, err = compressed_psum(g, "pod", e)
    return ({k: v[None] for k, v in out.items()},
            {k: v[None] for k, v in err.items()})

out = {}
err = None
for i, step in enumerate(steps):
    g = {k: jnp.stack([r[k] for r in step]) for k in ("a", "b")}
    if err is None:
        f = shard_map(lambda g: per_pod(g, None), mesh=mesh,
                      in_specs=(P("pod"),), out_specs=(P("pod"), P("pod")),
                      check_rep=False)
        red, err = jax.jit(f)(g)
    else:
        f = shard_map(per_pod, mesh=mesh, in_specs=(P("pod"), P("pod")),
                      out_specs=(P("pod"), P("pod")), check_rep=False)
        red, err = jax.jit(f)(g, err)
    for k in ("a", "b"):
        out[f"red{i}_{k}"] = np.asarray(red[k])
        out[f"err{i}_{k}"] = np.asarray(err[k])
np.savez(sys.argv[1], **out)
sys.stdout.flush()
os._exit(0)
"""

_PORT = _INPUTS + """
import os, sys
import numpy as np
import torch, torch.distributed as dist, torch.multiprocessing as mp
from repro_torch.distributed.compression import compressed_psum

def run(rank, store, out):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    steps = inputs()
    res = {}
    err = None
    for i, step in enumerate(steps):
        g = {k: torch.from_numpy(v) for k, v in step[rank].items()}
        red, err = compressed_psum(g, dist.group.WORLD, err)
        for k in ("a", "b"):
            res[f"red{i}_{k}"] = red[k].numpy()
            res[f"err{i}_{k}"] = err[k].numpy()
    np.savez(f"{out}.{rank}.npz", **res)
    dist.destroy_process_group()

if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[2], sys.argv[1]), nprocs=4)
"""


def _run(script, tmp_path, *args, name):
    path = tmp_path / name
    path.write_text(textwrap.dedent(script))
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, str(path), *map(str, args)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]


def test_compressed_psum_at_4_ranks_is_the_references_bit_for_bit(tmp_path):
    _jax()
    _run(_REF, tmp_path, tmp_path / "ref.npz", name="ref.py")
    _run(_PORT, tmp_path, tmp_path / "port", tmp_path / "store",
         name="port.py")
    ref = np.load(tmp_path / "ref.npz")
    for rank in range(4):
        got = np.load(tmp_path / f"port.{rank}.npz")
        for key in got.files:
            want = ref[key][rank]
            assert got[key].dtype == want.dtype, key
            assert got[key].tobytes() == want.tobytes(), (rank, key)
