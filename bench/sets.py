"""Run one cell several times, one process per run, and summarise.

    python3 bench/sets.py --workload <cell> --seeds 11,12,13 --seconds <s>
        [--trace 0|1] [--control 0|1] [--out FILE.jsonl]

Each run is ``bench/run.py`` with one seed; its result line and the
reading line before it (or its exit code and the end of its standard
error) go to ``--out`` as one JSON line.  With ``--control 1`` a run's
``correct`` and ``check`` are the control's, and the program's are printed
beside them.
The summary gives, per metric, the median and the spread (the distance
between the first and third quartiles of ``statistics.quantiles(n=4)``
over the median), and each run's check readings.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    lines, bad = [], 0
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, str(RUN), "--workload", args.workload,
                            "--seed", str(seed), "--seconds", str(args.seconds),
                            "--trace", str(args.trace), "--control", str(args.control)],
                           capture_output=True, text=True)
        rec = {"workload": args.workload, "seed": seed, "rc": p.returncode,
               "wall_s": time.perf_counter() - t0, "trace": args.trace}
        try:
            out_lines = p.stdout.strip().splitlines()
            line, reading = json.loads(out_lines[-1]), json.loads(out_lines[-2])["reading"]
            rec.update(line=line, reading=reading)
            lines.append(line)
        except (IndexError, KeyError, json.JSONDecodeError):
            bad += 1
        if p.returncode != 0 or "line" not in rec:
            rec["stderr"] = p.stderr[-3000:]
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        brief = {k: v["value"] for k, v in rec.get("line", {}).get("metrics", {}).items()}
        chk = rec.get("line", {}).get("check")
        prog = rec.get("reading", {}).get("program")
        print(json.dumps({"seed": seed, "rc": p.returncode, "wall_s": round(rec["wall_s"], 1),
                          "correct": rec.get("line", {}).get("correct"), "metrics": brief,
                          "check": chk, "program": prog}), flush=True)
        if "stderr" in rec:
            print(rec["stderr"][-1500:], flush=True)
    names = sorted({k for ln in lines for k in ln["metrics"]})
    summary = {}
    for k in names:
        vals = [ln["metrics"][k]["value"] for ln in lines if k in ln["metrics"]]
        summary[k] = {"median": statistics.median(vals), "spread": spread(vals), "n": len(vals)}
    print(json.dumps({"workload": args.workload, "runs": len(lines), "failed_runs": bad,
                      "summary": summary}), flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
