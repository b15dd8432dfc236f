"""The port stands alone: no JAX, nothing of the reference package."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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


def test_kernel_sources_live_in_the_port():
    from repro_torch.core import _native
    srcs = [p.name for p in _native.sources()]
    assert srcs == ["bfs_frontier.cu", "hotspot.cu", "needle_nw.cu",
                    "pathfinder.cu"]
    for p in _native.sources():
        assert p.parent == PORT / "csrc"
        text = p.read_text()
        # each says what it replaces, what bounds it, what it does about it
        assert "Replaces: the TPU kernel src/repro/core/pallas_emit.py:34" \
            in text, p.name
        assert "Bound on the H100" in text, p.name
        assert "__constant__ int" not in text and "extern \"C\" int" in text
