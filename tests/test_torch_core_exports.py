"""The port's ``repro_torch.core`` and ``repro_torch.core.api`` export every
name of the reference's ``__all__``, and ``BACKENDS`` is a live view of the
backend registry as there."""
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.api as japi  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.core.api as api  # noqa: E402


@pytest.mark.parametrize("ref, port", [(jcore, core), (japi, api)],
                         ids=["core", "core.api"])
def test_port_exports_every_reference_name(ref, port):
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert set(ref.__all__) <= set(port.__all__)


def test_f9_names_import():
    from repro_torch.core import (  # noqa: F401
        CacheStats,
        CompiledKernel,
        UnsupportedSpace,
        cache_clear,
        cache_resize,
        cache_size,
        cache_stats,
        cuda_memcpy_to_symbol,
        disable_disk_cache,
        enable_disk_cache,
    )
    from repro_torch.core.api import register_backend
    from repro_torch.core.backends import register_backend as reg
    assert register_backend is reg


@pytest.mark.parametrize("port", [core, api], ids=["core", "core.api"])
def test_backends_is_live(port):
    before = port.BACKENDS
    assert before == core.backend_names()
    core.register_backend("f9_probe", lambda *a, **k: None, {"barrier"})
    try:
        assert port.BACKENDS == core.backend_names() == before + ("f9_probe",)
    finally:
        core.unregister_backend("f9_probe")
    assert port.BACKENDS == core.backend_names() == before
    with pytest.raises(AttributeError):
        port.NO_SUCH_NAME  # noqa: B018
