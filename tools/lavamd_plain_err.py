#!/usr/bin/env python3
"""Hold each lavamd variant's force against the plain version.

    PYTHONPATH=src python tools/lavamd_plain_err.py DIR     # needs a card

``DIR`` holds what ``tools/lavamd_variants.cu`` wrote there: ``pos``,
``q``, ``nbr`` and one ``force_<variant>`` a variant, raw little-endian
arrays at the tool's size (1000 boxes of 100 particles, 27 neighbours,
alpha 0.5).  The plain version (``lower_cuda.lavamd_plain``) runs on the
card over those inputs in float32, as ``chip_smoke.py`` runs it, and in
float64.  For each variant the script prints the largest ``|force -
plain|`` against each, the largest ``|force - plain| / (1 + |plain|)``
against the float32 plain version, and the largest ``|force|``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import lower_cuda
from repro_torch.core.dim3 import Dim3

BOXES, PPB, NNEI, ALPHA = 1000, 100, 27, 0.5


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    d = Path(sys.argv[1])
    dev = torch.device("cuda")

    def load(name, dtype):
        return torch.from_numpy(np.fromfile(d / f"{name}.bin", dtype)).to(dev)

    bufs = {"pos": load("pos", np.float32), "q": load("q", np.float32),
            "nbr": load("nbr", np.int32).view(BOXES, NNEI),
            "force": torch.zeros(BOXES * PPB, device=dev)}
    params = {"nboxes": BOXES, "ppb": PPB, "nnei": NNEI, "alpha": ALPHA}
    want32 = lower_cuda.lavamd_plain(bufs, Dim3(BOXES), Dim3(PPB),
                                     **params)["force"]
    b64 = {**bufs, **{k: bufs[k].double() for k in ("pos", "q", "force")}}
    want64 = lower_cuda.lavamd_plain(b64, Dim3(BOXES), Dim3(PPB),
                                     **params)["force"]
    print(f"card: {torch.cuda.get_device_name(0)}; plain float32 against "
          f"float64: max abs "
          f"{float((want32.double() - want64).abs().max()):.4g}")
    for path in sorted(d.glob("force_*.bin")):
        got = load(path.stem, np.float32).double()
        diff = (got - want32.double()).abs()
        rel = diff / (1.0 + want32.double().abs())
        print(f"{path.stem[6:]:<18} max abs vs plain32 "
              f"{float(diff.max()):.4g}  vs plain64 "
              f"{float((got - want64).abs().max()):.4g}  rel "
              f"{float(rel.max()):.4g}  |force| up to "
              f"{float(got.abs().max()):.5g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
