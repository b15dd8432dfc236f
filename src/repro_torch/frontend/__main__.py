"""Frontend conformance gate: ``python -m repro_torch.frontend``.

Translates every corpus ``.cu`` kernel and launches it side by side
with its hand-written twin on the loop and vector backends, requiring
*bit-identical* output buffers - the executable form of the claim that
the frontend ingests CUDA source without changing semantics.  The
buffers lie on ``--device``: the card unless ``cpu`` is asked for.

``--inject`` is the gate's self-test: it re-translates needle_nw with a
planted macro override (``PENALTY=3``, a genuine mistranslation - the
oracle and the hand-written twin still use 2) and requires the gate to
FAIL.  A gate that rubber-stamps everything is itself caught.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core.cuda_suite import run_entry
from repro_torch.core.kernel import UnsupportedKernel
from repro_torch.core.memory import host_array
from repro_torch.frontend.suite import CORPUS, _bases, frontend_twin

#: backends the gate compares on (the same pair the conformance
#: matrix's mode="frontend" cells cover)
GATE_BACKENDS = ("loop", "vector")


def _bits(out: dict) -> dict[str, bytes]:
    return {k: host_array(getattr(v, "value", v)).tobytes()
            for k, v in out.items()}


def run_gate(kernels=CORPUS, backends=GATE_BACKENDS, inject: bool = False,
             device=None) -> list[dict]:
    rows = []
    for name in kernels:
        base = _bases()[name]
        overrides = ({"PENALTY": 3}
                     if inject and name == "needle_nw" else None)
        try:
            twin = frontend_twin(name, overrides)
        except UnsupportedKernel as e:
            rows.append({"kernel": name, "backend": "-",
                         "status": "unsupport",
                         "detail": str(e).splitlines()[0]})
            continue
        for backend in backends:
            base_out, _ = run_entry(base, backend, device=device)
            twin_out, _ = run_entry(twin, backend, with_reference=False,
                                    device=device)
            bb, tb = _bits(base_out), _bits(twin_out)
            bad = sorted(k for k in bb if bb[k] != tb.get(k))
            row = {"kernel": name, "backend": backend,
                   "status": "pass" if not bad else "fail"}
            if bad:
                row["detail"] = (f"buffers differ from hand-written "
                                 f"twin: {', '.join(bad)}")
            if overrides:
                row["injected"] = overrides
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.frontend", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernels", nargs="*", default=list(CORPUS),
                    choices=list(CORPUS), metavar="K",
                    help="corpus subset to gate (default: all)")
    ap.add_argument("--backends", nargs="*", default=list(GATE_BACKENDS),
                    choices=list(GATE_BACKENDS), metavar="B",
                    help="backends to compare on (default: loop vector)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the cell report as JSON")
    ap.add_argument("--inject", action="store_true",
                    help="plant a mistranslation (needle_nw PENALTY=3) "
                         "and require the gate to catch it")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    rows = run_gate(args.kernels, tuple(args.backends),
                    inject=args.inject, device=args.device)
    width = max(len(r["kernel"]) for r in rows) + 3
    for r in rows:
        line = (f"{r['kernel'] + '@cu':{width}s} {r['backend']:7s} "
                f"{r['status']}")
        if r.get("detail"):
            line += f"  ({r['detail']})"
        print(line)

    failed = [r for r in rows if r["status"] == "fail"]
    report = {"cells": rows, "failed": len(failed),
              "injected": bool(args.inject)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report: {args.json}")

    if failed:
        print(f"frontend gate: FAILED ({len(failed)} cell(s) not "
              f"bit-identical)", file=sys.stderr)
        return 1
    n_k = len({r['kernel'] for r in rows})
    print(f"frontend gate: passed ({n_k} kernels x "
          f"{len(args.backends)} backends, all bit-identical)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
