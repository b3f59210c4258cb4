"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Makes the weights and the traffic from the
seed, serves the cell's traffic through ``BatchingServer`` over the HOBBIT
backend on one card, measures for ``--seconds`` after a warm-up, checks the
served tokens against the plain reference, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` and, when
traced, ``breakdown``; then ``check``, each compared number beside its
limit.  Those numbers are also the last lines on standard error.  The line
before it holds ``reading``: the check's readings, the sample, the window's
counters and the set-up and window seconds.

``--control 1`` also reads the fp8 control (the reference computed one
precision below the configuration's) on the same positions and puts it in
the program's place: ``correct`` and ``check`` are then the control's,
which has to come out incorrect, and the program's own verdict is in
``reading``.  The benchmark's own runs leave it off.

Exits non-zero, printing no result, without a card, with fewer cards than
the cell asks for, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchlib import paths
    from benchlib.cell import run_cell

    manifest = paths.Manifest.load()
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: needs {cell['chips']} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    res = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START, control=bool(args.control))
    bad = loaded_forbidden()
    if bad:
        print(f"bench: forbidden modules loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": res["peak"]}
    if args.trace:
        if res.get("busy_s") is None:
            print("bench: the profiler recorded no device activity", file=sys.stderr)
            return 4
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["trace_window_s"]
    reading = dict(res["reading"], window_counters=res["window_counters"],
                   setup_s=res["setup_s"], window_s=res["window_s"], sample=res["sample"])
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["check"] = res["check"]
    for name, c in res["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps({"reading": reading}), flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
