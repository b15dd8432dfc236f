"""Rodinia-style text input formats (the suite's file-driven data pipeline).

The real Rodinia workloads do not synthesize their inputs in the host
program: ``nn`` streams latitude/longitude records out of ``cane``-style
database files, and ``hotspot`` reads its initial temperature and power
grids from whitespace-separated text files (``temp_64``/``power_64``).
Frameworks that only ever see ``rand()``-filled buffers skip the whole
ingest path, so the suite's nn/hotspot entries round-trip their inputs
through these genuine on-disk formats: ``make_args`` *formats* the
generated data to text and *parses* it back, and the parsed arrays are
what both the kernels and the NumPy oracles consume - any formatter or
parser drift shows up as an oracle mismatch, not as silently different
inputs.

Formats:

* **records** (nn's ``cane`` files): one record per line,
  ``<lat> <lng>`` as decimal text.  Rodinia's loader ``fscanf``s two
  floats per hurricane record; everything else on the line is ignored.
* **grid** (hotspot's ``temp_*``/``power_*`` files): one value per line
  in row-major order, ``rows * cols`` lines total.

Both parsers return ``float32`` arrays (the dtype the CUDA kernels use),
accept blank lines, and raise ``ValueError`` with the offending line
number on malformed input.
"""
from __future__ import annotations

import numpy as np


def format_records(lat: np.ndarray, lng: np.ndarray) -> str:
    """Render parallel lat/lng arrays as an nn-style record file."""
    lat = np.asarray(lat, np.float32)
    lng = np.asarray(lng, np.float32)
    if lat.shape != lng.shape or lat.ndim != 1:
        raise ValueError(
            f"records need matching 1-D lat/lng arrays; got {lat.shape} "
            f"and {lng.shape}")
    return "".join(f"{a:.6f} {b:.6f}\n" for a, b in zip(lat, lng,
                                                        strict=True))


def parse_records(text: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse an nn record file into ``(lat, lng)`` float32 arrays."""
    lat, lng = [], []
    for ln, line in enumerate(text.splitlines(), start=1):
        fields = line.split()
        if not fields:
            continue
        if len(fields) < 2:
            raise ValueError(
                f"record line {ln}: expected '<lat> <lng>', got {line!r}")
        try:
            lat.append(float(fields[0]))
            lng.append(float(fields[1]))
        except ValueError as e:
            raise ValueError(f"record line {ln}: {e}") from None
    return (np.asarray(lat, np.float32), np.asarray(lng, np.float32))


def format_grid(grid: np.ndarray) -> str:
    """Render a 2-D array as a hotspot-style one-value-per-line file."""
    grid = np.asarray(grid, np.float32)
    if grid.ndim != 2:
        raise ValueError(f"grid must be 2-D; got shape {grid.shape}")
    return "".join(f"{v:.6f}\n" for v in grid.reshape(-1))


def parse_grid(text: str, rows: int, cols: int) -> np.ndarray:
    """Parse a hotspot grid file into a ``(rows, cols)`` float32 array."""
    vals = []
    for ln, line in enumerate(text.splitlines(), start=1):
        fields = line.split()
        if not fields:
            continue
        try:
            vals.extend(float(f) for f in fields)
        except ValueError as e:
            raise ValueError(f"grid line {ln}: {e}") from None
    if len(vals) != rows * cols:
        raise ValueError(
            f"grid has {len(vals)} values, expected {rows}x{cols}"
            f"={rows * cols}")
    return np.asarray(vals, np.float32).reshape(rows, cols)
