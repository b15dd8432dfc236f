"""The port's shard backend at 4 host workers against the reference's
``shard`` on 4 forced XLA host devices, and nn, bfs_frontier, lud_diag,
kmeans, streamcluster and vecadd on the shard backends at 1, 2 and 4
host workers (``tests/test_torch_shard.py``'s rule).

A child process with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
runs the reference's ``loop`` and ``shard`` on inputs the parent made: six
suite entries that cover every combine mode (bfs_frontier ``max``,
lud_diag ``concat``, nn ``concat``/``sum``/``max``, kmeans
``concat``/``sum``, streamcluster ``sum``/``max``, vecadd the default
``sum``), ``blockmax`` and ``blocksum`` (``concat``, and its warned
``sum`` fallback on 13 blocks), and one kernel whose written buffer holds
NaN, ±inf, -0.0 and large values at launch, under ``sum``, ``max`` and
``min``.  Wherever the port's ``loop`` gives the reference's ``loop``
bits, the port's ``shard`` owes the reference's ``shard`` bits; every
other buffer agrees within the entry's tolerance.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_shard import (  # noqa: E402
    BY_NAME,
    HOSTS,
    make_blockmax,
    make_blocksum,
    shard_equals_inner,
    suite_out,
)

from repro_torch.core import index, launch  # noqa: E402
from repro_torch.core.kernel import KernelDef  # noqa: E402
from repro_torch.core.memory import host_array  # noqa: E402

ENTRIES = ("nn", "bfs_frontier", "lud_diag", "kmeans", "streamcluster",
           "vecadd")

#: the special kernel: 4 blocks of 16 over a 64-element buffer
SPECIAL = np.tile(np.array(
    [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e30, -1e30, 3.0, 1.5, -2.5, 1e-30,
     7.0, np.nan, -0.0, np.inf, 2.0], np.float32), 4)
SPECIAL_X = np.tile(np.array(
    [1.0, -0.0, np.nan, np.inf, -np.inf, 1e30, -3.0, 0.0, 2.0, -0.0, 5.0,
     np.nan, 0.0, 0.0, 0.0, 0.0], np.float32), 4)
#: (atomic, combine) pairs of the special kernel
SPECIAL_MODES = (("add", "sum"), ("max", "max"), ("min", "min"),
                 ("add", "max"), ("max", "sum"), ("min", "sum"))


def make_special(op: str, mode: str) -> KernelDef:
    """Block b's threads 0-7 apply ``atomic_<op>`` to out[16b + t] and
    threads 8-11 to out[t - 8], an element every block hits."""
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        v = index.take(st.glob["x"], gid)
        idx = torch.where(ctx.tid < 8, ctx.bid * 16 + ctx.tid,
                          torch.where(ctx.tid < 12, ctx.tid - 8, 64))
        f = getattr(ctx, "atomic_" + op)
        return st.set_glob(out=f(st.glob["out"], idx, v))

    return KernelDef(f"special_{op}_{mode}", (stage,), writes=("out",),
                     reads=("x", "out"), combines={"out": mode})


def _kernel_cases() -> dict:
    """name -> (port kernel, grid, block, inputs)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1024, dtype=np.float32)
    cases = {"blockmax": (make_blockmax(1024, {"out": "max"}), 16, 64,
                          {"x": x, "out": np.full(1, -np.inf, np.float32)})}
    for nb in (16, 13):
        xs = rng.standard_normal(nb * 64, dtype=np.float32)
        cases[f"blocksum{nb}"] = (make_blocksum(nb, 64, {"y": "concat"}),
                                  nb, 64, {"x": xs,
                                           "y": np.zeros(nb, np.float32)})
    for op, mode in SPECIAL_MODES:
        cases[f"special_{op}_{mode}"] = (make_special(op, mode), 4, 16,
                                         {"x": SPECIAL_X, "out": SPECIAL})
    return cases


KERNELS = _kernel_cases()

_CHILD = r"""
import sys, warnings
import numpy as np, jax, jax.numpy as jnp
assert jax.device_count() == 4, jax.device_count()
from repro.core import launch
from repro.core.cuda_suite import build_suite, run_entry
from repro.core.kernel import KernelDef

def blockmax(n, combines):
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        v = st.glob["x"][jnp.minimum(gid, n - 1)]
        v = jnp.where(gid < n, v, -jnp.inf)
        idx = jnp.zeros(v.shape, jnp.int32)
        return st.set_glob(out=ctx.atomic_max(st.glob["out"], idx, v))
    return KernelDef("blockmax", (stage,), writes=("out",),
                     reads=("x", "out"), combines=combines)

def blocksum(nb, block, combines):
    n = nb * block
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        v = jnp.where(gid < n, st.glob["x"][jnp.minimum(gid, n - 1)], 0.0)
        bid = jnp.full(v.shape, ctx.bid)
        return st.set_glob(y=ctx.atomic_add(st.glob["y"], bid, v))
    return KernelDef("blocksum", (stage,), writes=("y",), reads=("x", "y"),
                     combines=combines)

def special(op, mode):
    def stage(ctx, st):
        gid = ctx.bid * ctx.block_dim + ctx.tid
        v = st.glob["x"][gid]
        idx = jnp.where(ctx.tid < 8, ctx.bid * 16 + ctx.tid,
                        jnp.where(ctx.tid < 12, ctx.tid - 8, 64))
        f = getattr(ctx, "atomic_" + op)
        return st.set_glob(out=f(st.glob["out"], idx, v))
    return KernelDef(f"special_{op}_{mode}", (stage,), writes=("out",),
                     reads=("x", "out"), combines={"out": mode})

kernels = {"blockmax": (blockmax(1024, {"out": "max"}), 16, 64),
           "blocksum16": (blocksum(16, 64, {"y": "concat"}), 16, 64),
           "blocksum13": (blocksum(13, 64, {"y": "concat"}), 13, 64)}
for op, mode in %(modes)r:
    kernels[f"special_{op}_{mode}"] = (special(op, mode), 4, 16)

inp = np.load(sys.argv[1])
cases = sorted({k.split("/")[0] for k in inp.files})
suite = {e.name: e for e in build_suite(1)}
out = {}
warnings.simplefilter("ignore")
for name in cases:
    args = {k.split("/", 1)[1]: inp[k] for k in inp.files
            if k.startswith(name + "/")}
    for be in ("loop", "shard"):
        if name in suite:
            o, _ = run_entry(suite[name], be, args=dict(args),
                             with_reference=False)
        else:
            k, grid, block = kernels[name]
            o = launch(k, grid=grid, block=block, backend=be,
                       args={n: jnp.asarray(v) for n, v in args.items()})
        for b, v in o.items():
            out[f"{name}/{be}/{b}"] = np.asarray(getattr(v, "value", v))
np.savez(sys.argv[2], **out)
print("child-ok")
""" % {"modes": SPECIAL_MODES}


@pytest.fixture(scope="module", autouse=True)
def _child(tmp_path_factory):
    """Start the reference's child at the file's first test, so that it
    runs beside the port's cells; ``reference`` waits for it."""
    d = tmp_path_factory.mktemp("shard_parity")
    inputs = {}
    for name in ENTRIES:
        args = BY_NAME[name].make_args(np.random.default_rng(42))
        inputs.update({f"{name}/{k}": v for k, v in args.items()})
    for name, (_, _, _, args) in KERNELS.items():
        inputs.update({f"{name}/{k}": v for k, v in args.items()})
    np.savez(d / "in.npz", **inputs)
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(root, "src")]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(d / "in.npz"),
         str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(_child):
    """The reference's loop and 4-device shard outputs on every case."""
    proc, path = _child
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "child-ok" in out, err[-3000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _agree(name, port_loop, port_shard, ref, tol) -> int:
    """The parity rule on every buffer; returns how many were held bit
    for bit."""
    held = 0
    for b, pl in port_loop.items():
        rl, rs = ref[f"{name}/loop/{b}"], ref[f"{name}/shard/{b}"]
        ps = port_shard[b]
        if pl.tobytes() == rl.tobytes():
            held += 1
            assert ps.tobytes() == rs.tobytes(), (
                f"{name}: {b} differs from the reference's 4-device shard "
                f"bits where the port's loop gives its loop bits")
        else:
            np.testing.assert_allclose(ps, rs, rtol=tol, atol=tol,
                                       equal_nan=True, err_msg=f"{name}/{b}")
    return held


@pytest.mark.parametrize("hosts", HOSTS)
@pytest.mark.parametrize("name", ENTRIES)
@pytest.mark.parametrize("backend", ["shard", "shard_vector"])
def test_shard_equals_inner_bitwise(backend, name, hosts, monkeypatch):
    monkeypatch.setenv("CUPBOP_HOST_DEVICES", str(hosts))
    shard_equals_inner(name, backend, hosts)


@pytest.mark.parametrize("name", ENTRIES)
def test_four_workers_give_the_references_bits(name, reference,
                                               monkeypatch):
    monkeypatch.setenv("CUPBOP_HOST_DEVICES", "4")
    held = _agree(name, suite_out(name, "loop"), suite_out(name, "shard"),
                  reference, max(BY_NAME[name].tol, 2e-5))
    assert held >= 1


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_four_workers_give_the_references_bits_on_kernels(name, reference,
                                                          monkeypatch):
    monkeypatch.setenv("CUPBOP_HOST_DEVICES", "4")
    kernel, grid, block, args = KERNELS[name]

    def run(backend):
        out = launch(kernel, grid=grid, block=block, backend=backend,
                     args={k: torch.from_numpy(v.copy())
                           for k, v in args.items()})
        return {k: host_array(v) for k, v in out.items()}

    held = _agree(name, run("loop"), run("shard"), reference, 2e-5)
    assert held == len(args)
