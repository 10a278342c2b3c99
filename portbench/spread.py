"""Measure a cell's spread as the benchmark's bounds are set from it: two
sets of runs on the same seeds, each run a process of its own, one after
another, then for each end-to-end metric each set's median and spread (the
distance between the first and third quartile by
``statistics.quantiles(values, n=4)``, as a share of the median), and the
spread without the run farthest from the median (``trimmed``).

    python3 portbench/spread.py --workload <cell> --seed <n> [--seed <n> ...]
        [--sets 2] [--seconds S] [--extra-seed <n> ...] [--traced-seed <n> ...]
        [--out FILE.jsonl]

``--extra-seed`` runs add seeds for the check of outputs alone, with a
short window; ``--traced-seed`` runs are ``--trace 1``.  Every result line
goes to ``--out``; the last line of standard output is the summary as JSON.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run(cell: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return {"cell": cell, "seed": seed, "trace": trace, "seconds": seconds, "rc": p.returncode,
            "wall_s": time.perf_counter() - t0, "result": result,
            "setup_parts": next((x for x in p.stderr.splitlines() if x.startswith("set-up ")),
                                None),
            "stderr_tail": p.stderr[-3000:] if result is None or not result["correct"] else ""}


def spread(values: list) -> tuple:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return q2, (q3 - q1) / q2


def trimmed(values: list) -> float:
    """The spread without the run farthest from the median: the measure a
    bound's tightness is judged by (the mean of two sets' trimmed spreads)."""
    med = statistics.median(values)
    rest = sorted(values, key=lambda v: abs(v - med))[:-1]
    return spread(rest)[1] if len(rest) >= 2 else 0.0


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/spread.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", default=[])
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--extra-seed", type=int, action="append", default=[])
    ap.add_argument("--traced-seed", type=int, action="append", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    out = open(args.out, "a") if args.out else None
    records = []

    def keep(rec):
        records.append(rec)
        r = rec["result"]
        print(f"{rec['cell']} seed {rec['seed']} trace {rec['trace']}: rc {rec['rc']}, "
              f"{rec['wall_s']:.1f} s, correct {r and r['correct']}, "
              f"{r and {k: v['value'] for k, v in r['metrics'].items()}}", file=sys.stderr)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()

    sets = []
    for _ in range(args.sets):
        sets.append([run(args.workload, s, seconds, 0) for s in args.seed])
        for rec in sets[-1]:
            keep(rec)
    for s in args.extra_seed:
        keep(run(args.workload, s, min(seconds, 5), 0))
    for s in args.traced_seed:
        keep(run(args.workload, s, seconds, 1))
    summary = {"cell": args.workload, "seconds": seconds, "sets": []}
    for runs in sets:
        ok = [r["result"] for r in runs if r["result"]]
        names = sorted({k for r in ok for k in r["metrics"]})
        values = {k: [r["metrics"][k]["value"] for r in ok] for k in names}
        summary["sets"].append({k: dict(zip(("median", "spread"), spread(v)), trimmed=trimmed(v))
                                for k, v in values.items() if len(ok) >= 2})
    summary["correct"] = [bool(r["result"] and r["result"]["correct"]) for r in records]
    print(json.dumps(summary))
    return 0 if all(summary["correct"]) else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
