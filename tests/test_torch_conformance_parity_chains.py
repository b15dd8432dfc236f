"""The cross-framework column, continued: the chains' replay legs on
``vector`` and the grain points on ``loop``, each against the reference's
cell at the same point, on the CPU.

* Each of the seven chains' ``device_resident`` and ``graph`` points on
  ``vector`` (the reference's device-resident and graph-captured replays
  on its ``vector``);
* vecadd, scan_block and needle_nw at grains 1 and 3 on ``loop`` (the
  reference's ``loop``).

Statuses, bits and tolerances as ``tests/test_torch_conformance_parity.py``
sets them out; its helpers run both sides.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_conformance_parity import CASES, _check, _id, _points  # noqa: E402

#: the replay legs (the frontend leg's points, also not host, are held
#: against the reference in tests/test_torch_conformance_parity.py)
LEG_POINTS = [(name, *p) for name in CASES for p in _points(name)
              if p[-1] in ("device_resident", "graph")]
LOOP_POINTS = [(name, *p) for name in ("vecadd", "scan_block", "needle_nw")
               for p in _points(name) if p[0] in ("base", "grain")]


def test_every_chain_has_both_legs():
    chains = {p[0] for p in LEG_POINTS}
    assert chains == {"bfs_frontier", "pathfinder", "needle_nw", "srad_step",
                      "nn", "kmeans", "hotspot"}
    assert len(LEG_POINTS) == 2 * len(chains)


@pytest.mark.parametrize("point", LEG_POINTS, ids=_id)
def test_vector_replay_leg_agrees_with_the_reference(point):
    _check(point, "vector", "vector")


@pytest.mark.parametrize("point", LOOP_POINTS, ids=_id)
def test_loop_grain_points_agree_with_the_reference(point):
    _check(point, "loop", "loop")
