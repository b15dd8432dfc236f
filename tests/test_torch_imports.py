"""The port stands alone: no JAX, nothing of the reference package."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BENCH = sorted((ROOT / "benchmarks").glob("torch_*.py"))
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + BENCH
BANNED = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_torch)"
                    r"|from\s+(jax|jaxlib|repro)\b(?!_torch))", re.M)


def test_sources_import_neither_jax_nor_the_reference():
    found = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
             for p in FILES for m in BANNED.finditer(p.read_text())]
    assert not found, found


def test_scan_catches_what_it_must():
    assert BANNED.search("import jax.numpy as jnp")
    assert BANNED.search("from repro.core import api")
    assert BANNED.search("    import repro")
    assert not BANNED.search("from repro_torch.core import api")
    assert not BANNED.search("import repro_torch")


def test_every_module_imports_with_jax_and_reference_blocked():
    mods = sorted(".".join(p.relative_to(PORT.parent).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_streams_graphs_and_device_chains_stand_alone():
    # the modules of streams, events, graphs and device-resident chains
    # are scanned above, and their public names import and build a
    # stream, a graph and a chain with JAX and the reference blocked
    scanned = {p.relative_to(PORT).as_posix() for p in FILES
               if PORT in p.parents}
    assert {"core/streams.py", "core/graphs.py", "core/memory.py",
            "core/kernel.py", "core/cuda_suite.py"} <= scanned
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from repro_torch.core import (Event, Graph, GraphError, GraphExec,\n"
        "    Policy, Runtime, Stream, cuda_memcpy_async, cuda_suite)\n"
        "s = Stream({'a': torch.zeros(4)})\n"
        "g = s.begin_capture()\n"
        "s.device_update(lambda h: {'a': h['a'] + 1})\n"
        "s.end_capture()\n"
        "g.instantiate(s.buffers).launch(s)\n"
        "e = cuda_suite.entry_pathfinder()\n"
        "out, _ = cuda_suite.run_entry(e, 'vector', device='cpu',\n"
        "                              chain_mode='graph')\n"
        "assert s.buffers['a'].tolist() == [1.0] * 4\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_conformance_and_the_coverage_scripts_stand_alone():
    # the conformance module and the port's Table-II scripts are scanned
    # above, and run with JAX and the reference blocked: the matrix on
    # two cases, its CLI, and the coverage sweep's cheap columns
    scanned = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/core/conformance.py",
            "benchmarks/torch_coverage.py",
            "benchmarks/torch_check_coverage.py"} <= scanned
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "sys.path.insert(0, 'benchmarks')\n"
        "import torch_check_coverage, torch_coverage\n"
        "from repro_torch.core import conformance\n"
        "cases = [c for c in conformance.build_cases()\n"
        "         if c.name in ('vecadd', 'pathfinder')]\n"
        "rep = conformance.run_matrix(cases=cases,\n"
        "                             backends=('vector', 'cuda'),\n"
        "                             device='cpu')\n"
        "assert rep.cells and not rep.disagreements\n"
        "assert conformance.main(['--no-variants', '--kernels', 'reverse',\n"
        "                         '--backends', 'vector', 'cuda',\n"
        "                         '--device', 'cpu']) == 0\n"
        "torch_coverage.frameworks = lambda: ('vector', 'cuda')\n"
        "counts, _, n = torch_check_coverage.current_counts(device='cpu')\n"
        "assert counts == {'vector': 23, 'cuda': 23} and n == 23, counts\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_kernelcheck_and_the_optimizer_stand_alone():
    # analyze.py and optimize.py are scanned above, and analyze, gate,
    # plan and launch with JAX and the reference blocked
    scanned = {p.relative_to(PORT).as_posix() for p in FILES
               if PORT in p.parents}
    assert {"core/analyze.py", "core/optimize.py"} <= scanned
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "from repro_torch.core import analyze, cuda_suite, optimize\n"
        "assert analyze.main(['--kernels', 'pixel_pipeline,softmax_row',\n"
        "                     '--device', 'cpu']) == 0\n"
        "assert analyze.main(['--kernels', 'vecadd', '--inject-race',\n"
        "                     '--device', 'cpu']) == 1\n"
        "e = cuda_suite.entry_pixel_pipeline()\n"
        "out, _ = cuda_suite.run_entry(e, 'vector', device='cpu',\n"
        "                              optimize=True)\n"
        "derived = list(e.kernel._optimize_derived.values())\n"
        "assert isinstance(derived[0], optimize.OptimizedKernel)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


#: the frontend's modules (the reference's ``repro.frontend``, copied or
#: translated to torch), the gate's ``__main__`` among them
FRONTEND = ("frontend/__init__.py", "frontend/__main__.py",
            "frontend/lexer.py", "frontend/parser.py", "frontend/runtime.py",
            "frontend/suite.py", "frontend/translate.py")


def test_the_frontend_stands_alone():
    # its seven modules are scanned above (the lexer and parser, which
    # import no JAX in the reference either, are the port's own copies),
    # and translate, run the corpus's twins and gate with JAX and the
    # reference blocked
    scanned = {p.relative_to(PORT).as_posix() for p in FILES
               if PORT in p.parents}
    assert set(FRONTEND) <= scanned
    assert {p.relative_to(PORT).as_posix()
            for p in (PORT / "frontend").glob("*.py")} == set(FRONTEND)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import torch\n"
        "from repro_torch.frontend import TranslatedKernel, translate\n"
        "from repro_torch.frontend import lexer, parser, runtime, suite\n"
        "from repro_torch.frontend.__main__ import main\n"
        "tk = translate(suite.corpus_source('stencil1d'))\n"
        "assert isinstance(tk, TranslatedKernel) and len(tk.sources) == 2\n"
        "assert main(['--kernels', 'reverse', 'pathfinder', '--device',\n"
        "             'cpu']) == 0\n"
        "assert main(['--kernels', 'needle_nw', '--backends', 'vector',\n"
        "             '--inject', '--device', 'cpu']) == 1\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


#: the hot-path kernels' sources, each with the Pallas kernel it replaces
HOT_PATH = {"flash_attention.cu": "src/repro/kernels/flash_attention.py:34",
            "flash_attention_tc.cu":
                "src/repro/kernels/flash_attention.py:34",
            "flash_decode.cu": "src/repro/kernels/flash_attention.py:34",
            "matmul.cu": "src/repro/kernels/matmul.py:21",
            "matmul_tc.cu": "src/repro/kernels/matmul.py:21",
            "rmsnorm.cu": "src/repro/kernels/rmsnorm.py:17"}


def test_kernel_sources_live_in_the_port():
    from repro_torch.core import _native
    srcs = [p.name for p in _native.sources()]
    assert srcs == ["backprop_layer.cu", "bfs_frontier.cu",
                    "flash_attention.cu", "flash_attention_tc.cu",
                    "flash_decode.cu", "histogram.cu",
                    "hotspot.cu", "kmeans.cu", "lavamd.cu", "lud_diag.cu",
                    "matmul.cu", "matmul_tc.cu", "matmul_tiled.cu",
                    "needle_nw.cu", "nn.cu",
                    "pathfinder.cu", "pixel_pipeline.cu", "reduce_shared.cu",
                    "reduce_warp.cu", "reverse.cu", "rmsnorm.cu",
                    "scan_block.cu", "softmax_row.cu", "srad.cu",
                    "stencil1d.cu", "stencil2d.cu", "streamcluster.cu",
                    "transpose_tiled.cu", "vecadd.cu"]
    for p in _native.sources():
        assert p.parent == PORT / "csrc"
        text = p.read_text()
        # each says what it replaces, what bounds it, what it does about it
        replaces = HOT_PATH.get(p.name, "src/repro/core/pallas_emit.py:34")
        assert f"Replaces: the TPU kernel {replaces}" in text, p.name
        assert text.count("Replaces: the TPU kernel") == 1, p.name
        assert "Bound on the H100" in text, p.name
        assert "__constant__ int" not in text and "extern \"C\" int" in text


def test_the_serving_tier_and_the_disk_cache_stand_alone(tmp_path):
    # serve/, launch/ and core/compile_cache.py are scanned above, and
    # serve, batch and cache with JAX and the reference blocked
    scanned = {p.relative_to(PORT).as_posix() for p in FILES
               if PORT in p.parents}
    assert {"serve/__init__.py", "serve/kernel_service.py",
            "launch/__init__.py", "launch/serve.py",
            "core/compile_cache.py"} <= scanned
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "from repro_torch.core import api, compile_cache\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.serve import KernelService, ServiceStats\n"
        f"api.enable_disk_cache({str(tmp_path)!r})\n"
        "doc = serve.main(['--device', 'cpu', '--backend', 'vector',\n"
        "                  '--requests', '8', '--kernels', 'vecadd',\n"
        "                  'reverse'])\n"
        "assert doc['completed'] == 16 and doc['failed'] == 0, doc\n"
        "assert api.cache_stats().disk_stores == 0\n"
        "assert isinstance(compile_cache.artifact_key(\n"
        "    'f', 'cuda', (1, 1, 1), (1, 1, 1), 1, None, True, (), ()), str)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


#: makes ``import torch`` fail in a child interpreter, as in a job that
#: installs JAX and pytest but no torch
NO_TORCH = """\
import importlib.abc
import sys


class _NoTorch(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "torch" or name.startswith("torch."):
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None


sys.meta_path.insert(0, _NoTorch())
"""


def test_port_tests_skip_at_collection_without_torch(tmp_path):
    # every port test file skips where torch cannot be imported, so the
    # JAX package's tests beside them are still collected, with no error
    (tmp_path / "sitecustomize.py").write_text(NO_TORCH)
    files = ["tests/test_core.py", *sorted(
        p.relative_to(ROOT).as_posix()
        for p in (ROOT / "tests").glob("test_torch_*.py"))]
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}:{ROOT / 'src'}",
           "JAX_PLATFORMS": "cpu", "PYTEST_DISABLE_PLUGIN_AUTOLOAD": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", *files],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out
    assert "error" not in out.splitlines()[-1].lower(), out
    ids = [line for line in res.stdout.splitlines() if "::" in line]
    assert any(i.startswith("tests/test_core.py::") for i in ids), out
    assert not any(i.startswith("tests/test_torch_") for i in ids), out
