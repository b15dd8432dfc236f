"""``tests/test_property.py::test_quantize_bounded`` on the port's
``distributed.compression`` (a hypothesis property, as the reference's)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.distributed import compression as tcomp  # noqa: E402

SET = settings(max_examples=25, deadline=None)


@SET
@given(seed=st.integers(0, 100),
       scale=st.floats(1e-4, 1e4),
       bits=st.sampled_from([4, 8]))
def test_quantize_bounded(seed, scale, bits):
    g = torch.from_numpy(np.random.default_rng(seed)
                         .standard_normal(128).astype(np.float32) * scale)
    q, s = tcomp.quantize(g, bits)
    err = (tcomp.dequantize(q, s) - g).abs().numpy()
    assert err.max() <= float(s) * 0.5 * 1.001 + 1e-12
