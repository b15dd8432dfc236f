"""Coverage gate of the PyTorch port: fail when a backend's coverage drops.

    PYTHONPATH=src python benchmarks/torch_check_coverage.py [--device D]

The port's counterpart of ``benchmarks/check_coverage.py``.  It runs the
Table-II sweep (``benchmarks/torch_coverage.py``) on the card unless
``--device cpu`` is given, and holds each backend's count of correct
kernels and its coverage percentage against the committed
``benchmarks/torch_coverage_baseline.json``.  Any drop fails the gate; a
gain passes with a hint to refresh the baseline with ``--update``, which
writes it (never edit it by hand) together with the device of the run.
The percentage check matters apart from the counts: a suite that grows
by kernels no backend supports keeps every count flat and dilutes every
percentage.

``--disable KERNEL`` marks one suite kernel unsupported on every backend
before comparing, to show that the gate trips.  ``--json PATH`` writes
the measured counts and percentages, also when the gate fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch_coverage
from repro_torch.core.memory import resolve_device

BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_coverage_baseline.json")


def current_counts(disable: str | None = None, device=None,
                   seconds: dict | None = None) -> tuple[dict, dict, int]:
    table = torch_coverage.run(device=device, seconds=seconds)
    if disable is not None:
        if disable not in table:
            raise SystemExit(f"--disable {disable!r}: no such suite kernel; "
                             f"have {sorted(table)}")
        row, feats = table[disable]
        table[disable] = ({fw: "unsupport" for fw in row}, feats)
    counts = torch_coverage.counts(table)
    pct = torch_coverage.percentages(table)
    return counts, {fw: round(pct[fw], 1) for fw in counts}, len(table)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--update", "--write", action="store_true",
                    dest="write",
                    help="regenerate the baseline from the current suite "
                         "(instead of hand-editing it)")
    ap.add_argument("--disable", metavar="KERNEL",
                    help="artificially disable one kernel (gate self-test)")
    ap.add_argument("--baseline", default=BASELINE)
    ap.add_argument("--json", metavar="PATH",
                    help="write the measured counts/percentages here")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    device = str(resolve_device(args.device))
    seconds: dict[str, float] = {}
    t0 = time.perf_counter()
    counts, percent, n_kernels = current_counts(args.disable, device,
                                                seconds)
    wall = time.perf_counter() - t0
    print(f"sweep: device={device} seconds={wall:.2f} "
          + " ".join(f"{fw}={s:.2f}" for fw, s in seconds.items()))
    print(torch_coverage.paper_line(percent))
    measured = {"n_kernels": n_kernels, "backends": counts,
                "percent": percent, "device": device}

    if args.json:
        with open(args.json, "w") as f:
            json.dump(measured, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"coverage artifact written: {args.json}")

    if args.write:
        with open(args.baseline, "w") as f:
            json.dump(measured, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"baseline written: {args.baseline}")
        return 0

    try:
        with open(args.baseline) as f:
            base = json.load(f)
    except FileNotFoundError:
        print(f"FAIL: no baseline at {args.baseline}; commit one with "
              f"--update", file=sys.stderr)
        return 2

    failed = False
    base_pct = base.get("percent", {})
    for fw, want in sorted(base["backends"].items()):
        got = counts.get(fw)
        if got is None:
            print(f"FAIL {fw}: backend disappeared from the registry "
                  f"(baseline: {want}/{base['n_kernels']})",
                  file=sys.stderr)
            failed = True
        elif got < want:
            print(f"FAIL {fw}: {got}/{n_kernels} correct, baseline "
                  f"{want}/{base['n_kernels']}", file=sys.stderr)
            failed = True
        elif fw in base_pct and percent[fw] < base_pct[fw]:
            print(f"FAIL {fw}: coverage {percent[fw]}% below baseline "
                  f"{base_pct[fw]}%", file=sys.stderr)
            failed = True
        elif got > want:
            print(f"PASS {fw}: {got}/{n_kernels} correct "
                  f"({percent[fw]}%; baseline {want}; refresh with "
                  f"--update)")
        else:
            print(f"PASS {fw}: {got}/{n_kernels} correct ({percent[fw]}%)")
    for fw in sorted(set(counts) - set(base["backends"])):
        print(f"NOTE {fw}: new backend ({counts[fw]}/{n_kernels} correct), "
              f"not in baseline")

    if n_kernels < base["n_kernels"]:
        print(f"FAIL: suite shrank to {n_kernels} kernels "
              f"(baseline {base['n_kernels']})", file=sys.stderr)
        failed = True

    if failed:
        print("coverage gate: FAILED", file=sys.stderr)
        return 1
    print(f"coverage gate: passed (baseline written on "
          f"{base.get('device', 'an unrecorded device')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
