"""The port's dry-run machinery against the reference's
(``tests/test_dryrun.py``) on the CPU: ``abstract_params``, the input
specs, the cost analysis's FLOPs beside the reference's HLO analysis, and
one dry-run cell on a fake world (in a child process: the fake group
never starts in the pytest worker).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as TH  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _jax():
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.configs import registry
    from repro.launch import hlo_analysis
    from repro.models import transformer
    return jax, jnp, compat, registry, hlo_analysis, transformer


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch", list(treg.ARCHS))
def test_abstract_params_are_the_references_shapes_and_dtypes(arch):
    """Every leaf's shape and dtype is the reference's ``eval_shape``'s,
    but for the attention weights whose dummy heads the reference zeroes
    with a float32 mask: that product promotes them to float32 there, and
    the port keeps the parameters' dtype (``attention.init_attn_params``)."""
    jax, _, _, jreg, _, JT = _jax()
    flat, _ = jax.tree_util.tree_flatten_with_path(
        JT.abstract_params(jreg.get(arch)))
    ref = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path): leaf for path, leaf in flat}
    cfg = treg.get(arch)
    got = {}
    tshd.map_with_path(lambda p, t: got.__setitem__(tshd._path_str(p), t),
                       TT.abstract_params(cfg))
    assert set(got) == set(ref)
    plan = tattn.plan_for(cfg)
    for name, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[name].shape), name
        want = str(ref[name].dtype)
        if want != str(t.dtype).removeprefix("torch."):
            assert not plan.is_identity and name.split("/")[-1] in (
                "wq", "wk", "wv", "wo"), name
            assert want == "float32" and t.dtype == cfg.pdtype, name


def test_input_specs_shapes():
    cfg = treg.get("qwen2.5-32b")
    b = tspecs.input_specs(cfg, "train_4k")
    assert b["tokens"].shape == (256, 4096)
    d = tspecs.input_specs(cfg, "decode_32k")
    assert d["tokens"].shape == (128, 1)
    assert d["cache"]["k"].shape == (64, 128, 32768, 16, 128)  # kv padded 16
    v = tspecs.input_specs(treg.get("internvl2-76b"), "prefill_32k")
    assert v["tokens"].shape == (32, 32768 - 1024)
    assert v["patch_embeds"].shape == (32, 1024, 8192)
    a = tspecs.input_specs(treg.get("musicgen-medium"), "train_4k")
    assert a["tokens"].shape == (256, 4096, 4)
    assert all(t.device.type == "meta" for t in (b["tokens"],
                                                 d["cache"]["k"]))


def test_analyze_matches_the_references_loop_free():
    jax, jnp, compat, _, JH, _ = _jax()

    def f(x, w1, w2):
        return jnp.sum(jnp.tanh(x @ w1) @ w2)
    args = (jax.ShapeDtypeStruct((128, 256), jnp.float32),
            jax.ShapeDtypeStruct((256, 512), jnp.float32),
            jax.ShapeDtypeStruct((512, 64), jnp.float32))
    c = jax.jit(f).lower(*args).compile()
    ref = JH.analyze(c.as_text()).flops
    assert abs(ref - compat.xla_cost_analysis(c)["flops"]) / ref < 0.05
    ours = TH.analyze(lambda x, w1, w2: torch.sum(torch.tanh(x @ w1) @ w2),
                      _meta(128, 256), _meta(256, 512), _meta(512, 64))
    assert abs(ours.flops - ref) / ref < 0.05


def test_analyze_counts_every_trip_of_a_loop():
    def g(x, ws):
        for w in ws.unbind(0):
            x = torch.tanh(x @ w)
        return torch.sum(x)
    ours = TH.analyze(g, _meta(128, 256), _meta(10, 256, 256))
    expect = 2 * 128 * 256 * 256 * 10
    assert abs(ours.flops - expect) / expect < 0.05


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-moe-16b"])
def test_analyze_matches_the_references_smoke_forward(arch):
    jax, jnp, _, jreg, JH, JT = _jax()
    jc, tc = jreg.smoke(arch), treg.smoke(arch)
    B, S = 2, 32
    c = jax.jit(lambda p, t: JT.forward(jc, p, {"tokens": t})).lower(
        JT.abstract_params(jc),
        jax.ShapeDtypeStruct((B, S), jnp.int32)).compile()
    ref = JH.analyze(c.as_text()).flops
    ours = TH.analyze(lambda p, t: TT.forward(tc, p, {"tokens": t}),
                      TT.abstract_params(tc),
                      _meta(B, S, dtype=torch.int32))
    print(f"{arch} smoke forward: flops {ours.flops} against the "
          f"reference's {ref} ({ours.flops / ref - 1:+.4f})")
    assert abs(ours.flops - ref) / ref < 0.05, (ours.flops, ref)


def test_costs_add_and_scale():
    a = TH.Costs(1.0, 2.0, 3.0)
    a.coll_counts["all-gather"] += 2
    b = (a + a).scale(0.5)
    assert (b.flops, b.bytes, b.coll_bytes) == (1.0, 2.0, 3.0)
    assert b.coll_counts["all-gather"] == 2


def test_the_dry_run_writes_outside_experiments():
    assert "experiments" not in dryrun.DEFAULT_OUT.split(os.sep)
    assert dryrun.PEAK_FLOPS == 989.4e12 and dryrun.HBM_BW == 3.35e12


_CELL = r"""
import json, sys
import torch
import torch.distributed._functional_collectives as funcol
from repro_torch.launch import dryrun
dryrun.fake_world(8)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import hlo_analysis as H
mesh = shd.make_mesh((2, 4), ("data", "model"), device="cpu")
rec = dryrun.run_cell("qwen2-0.5b", "decode_32k", False, mesh=mesh)
x = torch.zeros(1024)
groups = {}
for dim in ("data", "model"):
    group = mesh.get_group(dim)
    costs = H.analyze(lambda t: funcol.all_reduce(t, "sum", group), x,
                      num_partitions=8)
    groups[dim] = costs.coll_bytes
with open(sys.argv[1], "w") as f:
    json.dump({"rec": rec, "groups": groups}, f)
"""


@pytest.fixture(scope="module")
def fake_cell(tmp_path_factory):
    """One child process on a fake (2, 4) world of 8 ranks: a dry-run
    cell and all-reduces over each mesh dim under the cost analysis."""
    tmp = tmp_path_factory.mktemp("cell")
    path = tmp / "cell.py"
    path.write_text(textwrap.dedent(_CELL))
    out = tmp / "cell.json"
    r = subprocess.run([sys.executable, str(path), str(out)],
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def test_an_all_reduce_counts_its_mesh_dims_group(fake_cell):
    """``n`` is the size of the group the op names (4 on ``model``, 2 on
    ``data``), not the world's 8: ring all-reduce link bytes 2(n-1)/n."""
    sz = 1024 * 4
    assert fake_cell["groups"]["model"] == 2.0 * sz * 3 / 4
    assert fake_cell["groups"]["data"] == 2.0 * sz * 1 / 2


def test_run_cell_on_a_fake_world(fake_cell):
    rec = fake_cell["rec"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "2x4"
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "peak_per_chip_gb", "fits_80gb_hbm"):
        assert key in rec["memory"], key
    for key in ("flops_per_chip", "hbm_bytes_per_chip",
                "coll_link_bytes_per_chip", "coll_counts"):
        assert key in rec["cost"], key
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "bound_step_s", "mfu_bound", "model_flops_per_chip"):
        assert key in rec["roofline"], key
    assert 0.99 < rec["replicated_work"] < 1.1
    assert isinstance(rec["reshards"], dict)
    assert rec["cost"]["flops_per_chip"] > 0
