"""The port's frontend against the reference's, on the CPU.

Both packages lex, parse and translate the same sources: the corpus's six
``.cu`` files (the port's copies byte-identical to the reference's) and
snippets for each diagnostic.  The token streams and ASTs must be equal,
and every diagnostic must give the same message on the same line (the
reserved-names one lists each package's own runtime names).  Each corpus
twin's buffers on ``loop`` and ``vector``, its inputs drawn by both from
``np.random.default_rng(42)``, must be the reference twin's bit for bit on
the same backend; so must a kernel's over an ``unsigned __shared__`` array
(the port keeps JAX's uint32 bits in int64 registers), on inputs made
from a seed.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.core import cuda_suite as jsuite  # noqa: E402
from repro.core.kernel import UnsupportedKernel as JUnsupportedKernel  # noqa: E402
from repro.frontend import lexer as jlexer  # noqa: E402
from repro.frontend import parser as jparser  # noqa: E402
from repro.frontend import suite as jfsuite  # noqa: E402
from repro.frontend import translate as jtranslate  # noqa: E402
from repro_torch.core import cuda_suite  # noqa: E402
from repro_torch.core.api import launch  # noqa: E402
from repro_torch.core.kernel import UnsupportedKernel  # noqa: E402
from repro_torch.frontend import lexer, parser, translate  # noqa: E402
from repro_torch.frontend import suite as fsuite  # noqa: E402
from test_torch_frontend import DIAGNOSTICS  # noqa: E402


def _ast(node):
    """A parser node as nested tuples of its class name and fields."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,) + tuple(
            (f.name, _ast(getattr(node, f.name)))
            for f in dataclasses.fields(node))
    if isinstance(node, (tuple, list)):
        return tuple(_ast(x) for x in node)
    return node


def _host(out) -> dict[str, bytes]:
    return {k: np.asarray(getattr(v, "value", v)).tobytes()
            for k, v in out.items()}


#: sources that translate in both packages, beside the corpus
SNIPPETS = {
    "early_return": """
        __global__ void k(int* out) {
            int t = threadIdx.x;
            if (t >= 4) return;
            out[t] = t + 1;
        }""",
    "for_and_carry": """
        #define K 5
        __global__ void k(int* out, const int* x) {
            __shared__ float s[8];
            int acc = 0;
            for (int i = 0; i < K; i++) { acc += i * x[threadIdx.x]; }
            s[threadIdx.x] = acc * 0.5f;
            __syncthreads();
            out[threadIdx.x] = acc > 3 ? s[7 - threadIdx.x] : -acc;
        }""",
    "atomics_and_warp": """
        __global__ void k(int* hist, int* flags, int* out, const int* x) {
            int t = threadIdx.x;
            atomicAdd(&hist[x[t] % 4], 1);
            int old = atomicCAS(&flags[0], 0, t + 1);
            int v = __shfl_xor_sync(0xffffffff, x[t], 3);
            int n = __syncthreads_count(x[t] > 2);
            out[t] = old + v * 10 + n * 100 + (__any_sync(0xffffffff, t > 30) ? 1000 : 0);
        }""",
}

#: translation diagnostics beyond the parser's, each with its line
TRANSLATE_DIAGNOSTICS = [
    ("__global__ void k(int* o, int n) {\n  o[0] = n;\n}", 1, "bind="),
    ("__global__ void k(int* o) {\n  __shared__ float o[4];\n}", 2,
     "shadows"),
    ("__global__ void k(int* o) {\n  int y = 1;\n  o[0] = z;\n}", 3,
     "unknown identifier"),
    ("__global__ void k(int* o) {\n  if (threadIdx.x) return;\n"
     "  __syncthreads();\n  o[1] = 2;\n}", 2, "before a later"),
    ("__global__ void k(const int* o) {\n  int x = o[0];\n}", 0,
     "no global buffer"),
    ("__global__ void k(int* o) {\n  int x = atomicMax(&o[0], 1);\n}", 2,
     "capturing"),
    ("__global__ void k(int* o) {\n  o[0] *= 2;\n}", 2, "out of subset"),
    ("__global__ void k(int* o) {\n  int x = (float)o[0];\n}", 2, None),
    ("__global__ void k(int* o) {\n  int x = 3;\n  if (x) { y = 2; }\n}",
     3, None),
]


def _error(fn, src):
    try:
        fn(src)
    except (UnsupportedKernel, JUnsupportedKernel) as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", fsuite.CORPUS)
def test_corpus_files_are_the_references_byte_for_byte(name):
    mine = (fsuite.CORPUS_DIR / f"{name}.cu").read_bytes()
    assert mine == (jfsuite.CORPUS_DIR / f"{name}.cu").read_bytes()
    assert fsuite.corpus_source(name) == jfsuite.corpus_source(name)


@pytest.mark.parametrize("src", [*(fsuite.corpus_source(n)
                                   for n in fsuite.CORPUS),
                                 *SNIPPETS.values()],
                         ids=[*fsuite.CORPUS, *SNIPPETS])
def test_tokens_and_ast_equal_the_references(src):
    assert [tuple(t) for t in lexer.tokenize(src)] == [
        tuple(t) for t in jlexer.tokenize(src)]
    assert lexer.macro_names(src) == jlexer.macro_names(src)
    assert _ast(parser.parse(src)) == _ast(jparser.parse(src))
    binds = {"N": 48, "DEG": 3} if "#define N " in src else {}
    assert _ast(parser.parse(src, binds)) == _ast(jparser.parse(src, binds))


@pytest.mark.parametrize(
    "src,line,msg",
    DIAGNOSTICS + TRANSLATE_DIAGNOSTICS
    + [("#define SQ(x) ((x)*(x))\n"
        "__global__ void k(int* o) { o[0] = SQ(2); }", 1, "function-like"),
       ("__global__ void k(int* o) { /* open\n", 1, "unterminated"),
       ("__global__ void k(int* o) {\n  o[0] = 1 @ 2;\n}", 2, "unexpected"),
       ("__global__ void k(int* o) {\n  int _x = 1;\n  o[0] = _x;\n}", 2,
        "collides")])
def test_diagnostics_equal_the_references(src, line, msg):
    mine = _error(lambda s: translate(s), src)
    theirs = _error(lambda s: jtranslate(s), src)
    assert mine is not None and theirs is not None, (mine, theirs)
    if msg is not None:
        assert msg in mine
    if line:
        assert f"line {line}" in mine, mine
    if "collides" in mine:
        # the reserved names are each package's own runtime's
        assert mine.split(" (reserved names")[0] == \
            theirs.split(" (reserved names")[0]
    else:
        assert mine == theirs


@pytest.mark.parametrize("backend", ["loop", "vector"])
@pytest.mark.parametrize("name", fsuite.CORPUS)
def test_twin_buffers_equal_the_reference_twins(name, backend):
    mine, _ = cuda_suite.run_entry(fsuite.frontend_twin(name), backend,
                                   with_reference=False, device="cpu")
    theirs, _ = jsuite.run_entry(jfsuite.frontend_twin(name), backend,
                                 with_reference=False)
    mine, theirs = _host(mine), _host(theirs)
    assert set(mine) == set(theirs)
    for k in theirs:
        assert mine[k] == theirs[k], k


def test_twins_keep_the_references_declarations():
    for name in fsuite.CORPUS:
        mine = fsuite.frontend_twin(name)
        theirs = jfsuite.frontend_twin(name)
        assert mine.kernel.writes == theirs.kernel.writes
        assert tuple(mine.kernel.reads) == tuple(theirs.kernel.reads)
        assert dict(mine.kernel.combines) == dict(theirs.kernel.combines)
        assert tuple(mine.kernel.donates) == tuple(theirs.kernel.donates)
        assert mine.kernel.uses_warp == theirs.kernel.uses_warp
        assert len(mine.kernel.stages) == len(theirs.kernel.stages)
        assert {k: s for k, (s, _) in mine.kernel.shared.items()} == {
            k: s for k, (s, _) in theirs.kernel.shared.items()}
        assert (mine.grid, mine.block, mine.dyn_shared) == (
            theirs.grid, theirs.block, theirs.dyn_shared)


#: an unsigned __shared__ array met by literals, signed tensors, floats,
#: blockDim, a loop counter, min/max, a masked assignment, ?: and a
#: literal-initialised local carried across the barrier (a tensor there),
#: each result stored to its own int32 (or float32) row
UNSIGNED = """
#define W 64
__global__ void k(const int* x, int* o, float* f) {
    __shared__ unsigned s[W];
    int t = threadIdx.x;
    int w = 3;
    s[t] = x[t];
    __syncthreads();
    unsigned u = s[W - 1 - t];
    unsigned v = u;
    if (t < 10) { v = 7; }
    int acc = 0;
    for (int i = 0; i < 3; i++) { acc = acc + (u > i); }
    o[t] = u + 1;
    o[W + t] = u > 5;
    o[2 * W + t] = u > t;
    o[3 * W + t] = u >> 3;
    o[4 * W + t] = u / 7;
    o[5 * W + t] = u * 3;
    o[6 * W + t] = u - 9;
    o[7 * W + t] = min(u, 100);
    o[8 * W + t] = (u & 255) + blockDim.x;
    o[9 * W + t] = -u;
    o[10 * W + t] = ~u;
    o[11 * W + t] = u % 10;
    o[12 * W + t] = u > -1;
    o[13 * W + t] = u << 4;
    o[14 * W + t] = v + acc;
    o[15 * W + t] = t > 20 ? u : 3;
    o[16 * W + t] = u + x[t];
    o[17 * W + t] = max(u, x[t]);
    o[18 * W + t] = __ballot_sync(0xffffffff, x[t] > 0) >> 20;
    o[19 * W + t] = u + w;
    f[t] = u * 0.5f;
    f[W + t] = u + 0.25f * t;
}
"""


@pytest.mark.parametrize("backend", ["loop", "vector"])
def test_unsigned_shared_gives_the_references_bits(backend):
    rng = np.random.default_rng(42)
    x = rng.integers(-2**31, 2**31, 64, dtype=np.int64).astype(np.int32)
    x[:4] = (-1, 0, 5, 2**31 - 1)
    tk = translate(UNSIGNED)
    assert tk.kernel.shared["s"] == ((64,), torch.int32)
    mine = launch(tk.kernel, grid=1, block=64, backend=backend,
                  args={"x": torch.from_numpy(x),
                        "o": torch.zeros(20 * 64, dtype=torch.int32),
                        "f": torch.zeros(128, dtype=torch.float32)})
    with warnings.catch_warnings():
        # JAX warns that a uint32 value scatters into int32 buffers
        warnings.simplefilter("ignore", FutureWarning)
        theirs = japi.launch(jtranslate(UNSIGNED).kernel, grid=1, block=64,
                             backend=backend,
                             args={"x": jnp.asarray(x),
                                   "o": jnp.zeros(20 * 64, jnp.int32),
                                   "f": jnp.zeros(128, jnp.float32)})
    for k in ("o", "f"):
        got, want = mine[k].numpy(), np.asarray(theirs[k])
        for row in range(len(want) // 64):
            np.testing.assert_array_equal(
                got[row * 64:(row + 1) * 64], want[row * 64:(row + 1) * 64],
                err_msg=f"{k} row {row}")
