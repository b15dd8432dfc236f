"""The port's CUDA-C source frontend (``repro_torch.frontend``) on the CPU.

The structure of ``tests/test_frontend.py``, on the port: the parser's
stage splitting and declarations, the line-numbered diagnostics, the
translator's atomics, warp intrinsics, early return, constant-trip
``for`` and carried registers, fingerprint stability, the six corpus
twins bit for bit their hand-written entries on ``loop`` and ``vector``,
the gate's ``--inject`` self-test and its CLI.  Then what the port adds:
the generated code's JAX scalar rules on torch tensors, the ``unsigned``
registers, and the ``cuda`` backend's refusal of a translated kernel.
The cross-framework column (tokens, ASTs, diagnostics and buffers against
the reference's frontend) is ``tests/test_torch_frontend_parity.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import enable_x64
from repro_torch.core.api import launch
from repro_torch.core.cuda_suite import run_entry
from repro_torch.core.kernel import UnsupportedKernel
from repro_torch.frontend import runtime, translate
from repro_torch.frontend.__main__ import main as gate_main
from repro_torch.frontend.__main__ import run_gate
from repro_torch.frontend.suite import (
    CORPUS,
    CORPUS_DIR,
    _bases,
    corpus_source,
    frontend_twin,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(out):
    return {k: getattr(v, "value", v).numpy().tobytes()
            for k, v in out.items()}


def _i32(*vals):
    return torch.tensor(vals, dtype=torch.int32)


def _zeros(n, dtype=torch.int32):
    return torch.zeros(n, dtype=dtype)


# --------------------------------------------------------------- parser ----
def test_barrier_splits_stages():
    tk = translate("""
        __global__ void k(float* out) {
            int t = threadIdx.x;
            out[t] = 1.0f;
            __syncthreads();
            out[t] = out[t] + 1.0f;
            __syncthreads();
            out[t] = out[t] * 2.0f;
        }""")
    assert len(tk.kernel.stages) == 3
    assert len(tk.sources) == 3
    out = launch(tk.kernel, grid=1, block=4,
                 args={"out": _zeros(4, torch.float32)})
    assert out["out"].tolist() == [4.0] * 4


def test_shared_decl_mapping():
    tk = translate("""
        __global__ void k(float* out) {
            __shared__ float s[16 + 2];
            __shared__ int flags[4];
            __shared__ double wide[2];
            s[threadIdx.x] = 0.0f;
            flags[threadIdx.x] = 0;
            __syncthreads();
            out[threadIdx.x] = s[threadIdx.x];
        }""")
    assert tk.kernel.shared["s"] == ((18,), torch.float32)
    assert tk.kernel.shared["flags"] == ((4,), torch.int32)
    # double follows the x64 switch when the launch allocates it
    assert tk.kernel.shared["wide"] == ((2,), torch.float64)
    assert tk.kernel.resolved_shared(None)["wide"] == ((2,), torch.float32)
    with enable_x64():
        assert tk.kernel.resolved_shared(None)["wide"][1] == torch.float64


def test_extern_shared_is_dynamic():
    tk = translate("""
        __global__ void k(int* d) {
            extern __shared__ int s[];
            s[threadIdx.x] = d[threadIdx.x];
            __syncthreads();
            d[threadIdx.x] = s[threadIdx.x];
        }""")
    assert tk.kernel.shared["s"] == ((-1,), torch.int32)


def test_unsigned_shared_holds_its_bits_as_int32():
    tk = translate("""
        __global__ void k(const int* x, int* out) {
            __shared__ unsigned s[4];
            __shared__ uint32_t r[4];
            s[threadIdx.x] = x[threadIdx.x];
            r[threadIdx.x] = 0;
            __syncthreads();
            out[threadIdx.x] = s[threadIdx.x] > 5;
        }""")
    assert tk.kernel.shared["s"] == ((4,), torch.int32)
    assert tk.kernel.shared["r"] == ((4,), torch.int32)
    out = launch(tk.kernel, grid=1, block=4,
                 args={"x": _i32(-1, 3, 6, -7), "out": _zeros(4)})
    # -1 and -7 are 0xffffffff and 0xfffffff9 unsigned: above 5
    assert out["out"].tolist() == [1, 0, 1, 1]


def test_constant_maps_to_reads():
    tk = translate("""
        #define N 8
        __constant__ int lut[N];
        __global__ void k(int* out) {
            out[threadIdx.x] = lut[threadIdx.x];
        }""")
    assert tk.constants == ("lut",)
    assert "lut" in tk.kernel.reads
    assert tk.kernel.writes == ("out",)


def test_writes_follow_param_order():
    tk = translate("""
        __global__ void k(int* a, const int* b, int* c, int* unused) {
            int t = threadIdx.x;
            c[t] = b[t];
            a[t] = b[t];
        }""")
    # param order, not store order; never-written pointers excluded
    assert tk.kernel.writes == ("a", "c")
    assert tk.kernel.reads == ("a", "b", "c", "unused")


def test_scalar_param_requires_bind():
    src = """
        __global__ void k(float* out, int n) {
            if (threadIdx.x < n) { out[threadIdx.x] = 1.0f; }
        }"""
    with pytest.raises(UnsupportedKernel, match="bind"):
        translate(src)
    tk = translate(src, bind={"n": 4})
    assert "4" in tk.sources[0]


def test_macro_bind_overrides_define():
    src = """
        #define SCALE 2
        __global__ void k(int* out) {
            out[threadIdx.x] = SCALE;
        }"""
    out = launch(translate(src).kernel, grid=1, block=4,
                 args={"out": _zeros(4)})
    assert out["out"].tolist() == [2, 2, 2, 2]
    out = launch(translate(src, bind={"SCALE": 7}).kernel, grid=1, block=4,
                 args={"out": _zeros(4)})
    assert out["out"].tolist() == [7, 7, 7, 7]


#: the reference's diagnostics, each with its line and message
DIAGNOSTICS = [
    ("__global__ void k(int* o) {\n  while (1) { o[0] = 1; }\n}",
     2, "out of subset"),
    ("__global__ void k(int* o) {\n  int* p;\n}", 2, "pointer"),
    ("__global__ void k(int* o) {\n  __shared__ int s[4][4];\n}",
     2, "multi-dimensional"),
    ("__global__ void k(int* o) {\n  o[threadIdx.x] = frobnicate(3);\n}",
     2, "unknown function"),
    ("__global__ void k(int* o) {\n  if (threadIdx.x == 0) {\n"
     "    __syncthreads();\n  }\n}", 3, "uniform"),
    ("__global__ void k(int* o) {\n  int x = 3;\n  x[2] = 1;\n}",
     3, "subscript"),
]


@pytest.mark.parametrize("src,line,msg", DIAGNOSTICS)
def test_diagnostics_name_the_line(src, line, msg):
    with pytest.raises(UnsupportedKernel, match=msg) as exc:
        translate(src)
    assert f"line {line}" in str(exc.value)


def test_function_like_macro_rejected():
    with pytest.raises(UnsupportedKernel, match="function-like"):
        translate("#define SQ(x) ((x)*(x))\n"
                  "__global__ void k(int* o) { o[0] = SQ(2); }")


@pytest.mark.parametrize("name", ["torch", "_rt", "_take"])
def test_the_runtime_names_are_reserved(name):
    with pytest.raises(UnsupportedKernel, match="collides") as exc:
        translate(f"__global__ void k(int* o) {{\n  int {name} = 1;\n"
                  f"  o[0] = {name};\n}}")
    assert "line 2" in str(exc.value)
    assert "'torch'" in str(exc.value)


# ----------------------------------------------------------- translator ----
def test_atomic_add_lowers_to_ctx_call():
    tk = translate("""
        __global__ void k(int* hist, const int* x) {
            atomicAdd(&hist[x[threadIdx.x]], 1);
        }""")
    assert "ctx.atomic_add(hist" in tk.sources[0]
    out = launch(tk.kernel, grid=1, block=4,
                 args={"hist": _zeros(3), "x": _i32(0, 1, 1, 2)})
    assert out["hist"].tolist() == [1, 2, 1]


def test_atomic_cas_captures_old():
    tk = translate("""
        __global__ void k(int* flags, int* won) {
            int old = atomicCAS(&flags[0], 0, 1);
            won[threadIdx.x] = old == 0;
        }""")
    out = launch(tk.kernel, grid=1, block=4,
                 args={"flags": _zeros(1), "won": _zeros(4)})
    # serialized thread order: only thread 0 sees the pre-swap 0
    assert out["won"].tolist() == [1, 0, 0, 0]


def test_atomic_exch_statement_form():
    tk = translate("""
        __global__ void k(int* slot) {
            atomicExch(&slot[0], threadIdx.x);
        }""")
    out = launch(tk.kernel, grid=1, block=4, args={"slot": _zeros(1)})
    assert out["slot"].tolist() == [3]            # last thread survives


def test_masked_atomic_drops_inactive_threads():
    tk = translate("""
        __global__ void k(int* total, const int* x) {
            if (x[threadIdx.x] > 0) {
                atomicAdd(&total[0], x[threadIdx.x]);
            }
        }""")
    out = launch(tk.kernel, grid=2, block=4,
                 args={"total": _zeros(1), "x": _i32(3, -1, 4, 0)})
    assert out["total"].tolist() == [14]          # two blocks of 3 + 4


def test_shfl_and_ballot_set_uses_warp():
    tk = translate("""
        __global__ void k(int* out, const int* x) {
            int t = threadIdx.x;
            int v = __shfl_sync(0xffffffff, x[t], 5);
            int b = __ballot_sync(0xffffffff, x[t] > 0);
            out[t] = v + b * 0;
        }""")
    assert tk.kernel.uses_warp
    x = torch.arange(32, dtype=torch.int32)
    out = launch(tk.kernel, grid=1, block=32,
                 args={"out": _zeros(32), "x": x})
    assert out["out"].tolist() == [5] * 32


def test_ballot_is_an_unsigned_register():
    tk = translate("""
        __global__ void k(int* out, const int* x) {
            unsigned b = __ballot_sync(0xffffffff, x[threadIdx.x] > 0);
            out[threadIdx.x] = b > 0;
        }""")
    x = torch.full((32,), -1, dtype=torch.int32)
    x[31] = 1                                     # bit 31: negative as int
    out = launch(tk.kernel, grid=1, block=32,
                 args={"out": _zeros(32), "x": x})
    assert out["out"].tolist() == [1] * 32


def test_syncthreads_count_matches_oracle():
    tk = translate("""
        __global__ void k(int* out, const int* x) {
            int n = __syncthreads_count(x[threadIdx.x] > 10);
            out[threadIdx.x] = n;
        }""")
    assert tk.kernel.uses_warp
    x = torch.arange(32, dtype=torch.int32)
    out = launch(tk.kernel, grid=1, block=32,
                 args={"out": _zeros(32), "x": x})
    assert out["out"].tolist() == [int((x > 10).sum())] * 32


def test_early_return_masks_remainder():
    tk = translate("""
        __global__ void k(int* out) {
            int t = threadIdx.x;
            if (t >= 4) return;
            out[t] = t + 1;
        }""")
    out = launch(tk.kernel, grid=1, block=8, args={"out": _zeros(8)})
    assert out["out"].tolist() == [1, 2, 3, 4, 0, 0, 0, 0]


def test_constant_trip_for_unrolls_at_trace():
    tk = translate("""
        #define K 5
        __global__ void k(int* out) {
            int acc = 0;
            for (int i = 0; i < K; i++) {
                acc = acc + i;
            }
            out[threadIdx.x] = acc;
        }""")
    assert "for i in range(0, 5, 1):" in tk.sources[0]
    out = launch(tk.kernel, grid=1, block=4, args={"out": _zeros(4)})
    assert out["out"].tolist() == [10] * 4


def test_carry_across_barrier():
    tk = translate("""
        __global__ void k(int* out, const int* x) {
            __shared__ int s[8];
            int t = threadIdx.x;
            int mine = x[t];
            s[7 - t] = mine;
            __syncthreads();
            out[t] = s[t] + mine;
        }""")
    # `mine` and `t` must ride st.priv across the barrier
    assert "_carry(mine, ctx.tid)" in tk.sources[0]
    x = np.arange(8, dtype=np.int32)
    for backend in ("loop", "vector"):
        out = launch(tk.kernel, grid=1, block=8, backend=backend,
                     args={"out": _zeros(8), "x": torch.from_numpy(x)})
        assert out["out"].tolist() == (x[::-1] + x).tolist()


def test_fingerprint_stable_across_translations():
    src = """
        __global__ void k(float* out) {
            out[threadIdx.x] = 0.5f;
        }"""
    assert (translate(src).kernel.fingerprint()
            == translate(src).kernel.fingerprint())
    other = src.replace("0.5f", "0.25f")
    assert (translate(src).kernel.fingerprint()
            != translate(other).kernel.fingerprint())
    for fn in translate(src).kernel.stages:
        assert fn.__closure__ is None


# --------------------------------------- JAX's scalar rules on torch ------
def test_min_max_take_python_scalars_and_keep_int32():
    tk = translate("""
        #define NN 6
        __global__ void k(const int* x, int* out) {
            int gid = blockIdx.x * blockDim.x + threadIdx.x;
            out[gid] = x[max(0, min(gid - 1, NN - 1))] + max(1, 2);
        }""")
    out = launch(tk.kernel, grid=2, block=4,
                 args={"x": torch.arange(10, 18, dtype=torch.int32),
                       "out": _zeros(8)})
    assert out["out"].dtype == torch.int32
    assert out["out"].tolist() == [12, 12, 13, 14, 15, 16, 17, 17]


def test_gathers_clamp_out_of_range_indices_as_jax_does():
    tk = translate("""
        __global__ void k(const int* x, int* out) {
            out[threadIdx.x] = x[threadIdx.x + 100] + x[threadIdx.x - 9];
        }""")
    out = launch(tk.kernel, grid=1, block=4,
                 args={"x": _i32(1, 2, 3, 4), "out": _zeros(4)})
    # x[100..] clamps to x[3]; x[-9..-6] wraps once then clamps to x[0]
    assert out["out"].tolist() == [5, 5, 5, 5]


@pytest.mark.parametrize("cmp,taken", [(">", "b"), ("<", "a")])
def test_constant_condition_masks_both_branches(cmp, taken):
    # a condition that folds stores in the branch taken alone (the
    # reference masks its else branch with ~True == -2, a true mask)
    tk = translate(f"""
        #define N 64
        __global__ void k(int* a, int* b) {{
            if (N {cmp} 100) {{
                a[threadIdx.x] = 1;
            }} else {{
                b[threadIdx.x] = 2;
            }}
        }}""")
    out = launch(tk.kernel, grid=1, block=4,
                 args={"a": _zeros(4), "b": _zeros(4)})
    want = {"a": [1] * 4 if taken == "a" else [0] * 4,
            "b": [2] * 4 if taken == "b" else [0] * 4}
    assert {k: v.tolist() for k, v in out.items()} == want


def test_int_tensor_meets_float_literal_in_the_default_float():
    tk = translate("""
        __global__ void k(float* out) {
            out[threadIdx.x] = threadIdx.x * 0.5f;
        }""")
    assert "_rt.tofloat(_tidx)" in tk.sources[0]
    out = launch(tk.kernel, grid=1, block=4,
                 args={"out": _zeros(4, torch.float32)})
    assert out["out"].tolist() == [0.0, 0.5, 1.0, 1.5]


@pytest.mark.parametrize("x64", [False, True])
def test_carry_takes_jax_types_on_the_thread_device(x64):
    tid = torch.arange(4, dtype=torch.int32)
    with enable_x64(x64):
        i, f = runtime.carry(5, tid), runtime.carry(2.5, tid)
    assert i.dtype == (torch.int64 if x64 else torch.int32)
    assert f.dtype == (torch.float64 if x64 else torch.float32)
    assert i.tolist() == [5] * 4 and i.device == tid.device
    assert runtime.carry(torch.tensor(7, dtype=torch.int8),
                         tid).dtype == torch.int8
    assert runtime.carry(tid, tid) is tid
    with pytest.raises(UnsupportedKernel, match="thread-chunk"):
        runtime.carry(torch.zeros(3), tid)


def test_unsigned_values_out_of_subset_are_refused():
    head = ("__global__ void k(const int* x, int* out) {\n"
            "  __shared__ unsigned s[4];\n")
    cases = {
        "  s[0] = 1.5f;\n": "float value stored to unsigned",
        "  out[0] = expf(s[0]);\n": "expf of an unsigned value",
        "  out[0] = s[0] + max(1, 2);\n": "weak type",
    }
    for body, msg in cases.items():
        with pytest.raises(UnsupportedKernel, match=msg) as exc:
            translate(head + body + "}")
        assert "line 3" in str(exc.value)


# --------------------------------------------- corpus twin bit-identity ----
def test_corpus_is_the_six_kernels():
    assert CORPUS == ("vecadd", "reverse", "stencil1d", "bfs_frontier",
                      "pathfinder", "needle_nw")
    assert sorted(p.name for p in CORPUS_DIR.glob("*.cu")) == sorted(
        f"{n}.cu" for n in CORPUS)
    assert "__global__ void vecadd" in corpus_source("vecadd")


@pytest.mark.parametrize("backend", ["loop", "vector"])
@pytest.mark.parametrize("name", CORPUS)
def test_corpus_twin_bit_identical(name, backend):
    base_out, _ = run_entry(_bases()[name], backend, device="cpu")
    twin = frontend_twin(name)
    assert twin.name == f"{name}@cu" and twin.kernel.native is None
    twin_out, want = run_entry(twin, backend, device="cpu")
    assert _bits(base_out) == _bits(twin_out)
    for k, v in want.items():           # the twin's flattened oracle
        np.testing.assert_allclose(twin_out[k].numpy(), v,
                                   rtol=_bases()[name].tol,
                                   atol=_bases()[name].tol)


def test_cuda_refuses_a_translated_kernel():
    with pytest.raises(UnsupportedKernel, match="no hand-written CUDA"):
        run_entry(frontend_twin("vecadd"), "cuda", device="cpu")


def test_injected_mistranslation_is_caught():
    """The gate's --inject self-test: a planted macro override must
    produce divergent bits (a gate that cannot fail gates nothing)."""
    base_out, _ = run_entry(_bases()["needle_nw"], "loop", device="cpu")
    twin_out, _ = run_entry(
        frontend_twin("needle_nw", overrides={"PENALTY": 3}), "loop",
        with_reference=False, device="cpu")
    assert _bits(base_out) != _bits(twin_out)


def test_gate_cli_reports_pass():
    rows = run_gate(kernels=("vecadd",), backends=("loop",), device="cpu")
    assert [r["status"] for r in rows] == ["pass"]


def test_gate_inject_fails_and_writes_its_report(tmp_path, capsys):
    path = tmp_path / "gate.json"
    rc = gate_main(["--kernels", "needle_nw", "vecadd", "--backends",
                    "vector", "--inject", "--device", "cpu", "--json",
                    str(path)])
    assert rc == 1
    assert "frontend gate: FAILED (1 cell(s)" in capsys.readouterr().err
    import json
    report = json.loads(path.read_text())
    assert report["injected"] and report["failed"] == 1
    bad = [c for c in report["cells"] if c["status"] == "fail"]
    assert [c["kernel"] for c in bad] == ["needle_nw"]
    assert bad[0]["injected"] == {"PENALTY": 3}


def test_gate_runs_as_a_module():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.frontend", "--device", "cpu",
         "--kernels", "reverse", "vecadd"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "frontend gate: passed (2 kernels x 2 backends" in res.stdout


# ------------------------------- the twins at other sizes (phase 3d (b)) ----
def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: small sizes of each corpus entry, as chip_smoke.FRONTEND_SIZES gives them
SMALL = {"vecadd": {"n": 1000, "block": 128}, "reverse": {"n": 256},
         "stencil1d": {"n": 1000, "block": 128},
         "bfs_frontier": {"n": 96, "deg": 3},
         "pathfinder": {"cols": 300, "rows": 4},
         "needle_nw": {"n": 48, "penalty": 10}}


@pytest.mark.parametrize("name", CORPUS)
def test_a_twin_bound_to_another_size_is_its_entry_bit_for_bit(name):
    from repro_torch.core import cuda_suite
    smoke = _chip_smoke()
    entry = getattr(cuda_suite, f"entry_{name}")(**SMALL[name])
    binds = smoke.frontend_binds(name, SMALL[name], entry,
                                 corpus_source(name))
    twin = frontend_twin(name, binds, base=entry)
    want, _ = run_entry(entry, "vector", device="cpu")
    got, oracle = run_entry(twin, "vector", device="cpu")
    assert _bits(got) == _bits(want)
    for k, v in oracle.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=entry.tol,
                                   atol=entry.tol)


def test_phase_3d_sizes_start_at_the_entries_and_bind_the_sources():
    from repro_torch.core import cuda_suite
    smoke = _chip_smoke()
    assert list(smoke.FRONTEND_SIZES) == list(CORPUS)
    for name, sizes in smoke.FRONTEND_SIZES.items():
        assert sizes[0] == smoke.SIZES[name]
        for size in sizes:
            entry = getattr(cuda_suite, f"entry_{name}")(**size)
            binds = smoke.frontend_binds(name, size, entry,
                                         corpus_source(name))
            assert binds and all(isinstance(v, int) for v in binds.values())
    full = smoke.FRONTEND_SIZES
    runs = {n: smoke.frontend_block_runs(
        n, full[n][0], getattr(cuda_suite, f"entry_{n}")(**full[n][0]))
        for n in CORPUS}
    assert runs == {"vecadd": 131072, "reverse": 1, "stencil1d": 131072,
                    "bfs_frontier": 31250, "pathfinder": 1563 * 99,
                    "needle_nw": 4095 * 128}


def test_phase_3d_refuses_a_bind_the_source_does_not_define():
    from repro_torch.core import cuda_suite
    smoke = _chip_smoke()
    entry = cuda_suite.entry_pathfinder(cols=300, rows=4)
    with pytest.raises(AssertionError, match="not macros"):
        smoke.frontend_binds("pathfinder", {"cols": 300, "rows": 4}, entry,
                             corpus_source("vecadd"))
    wide = cuda_suite.entry_stencil1d(1024, 256)
    assert smoke.frontend_binds("stencil1d", {"n": 1024, "block": 256}, wide,
                                corpus_source("stencil1d")) == {
        "NN": 1024, "BLOCK": 256}
