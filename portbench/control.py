"""The control of a cell's check: the plain reference put in the program's
place, computed a precision below the configuration's (ciphertexts mod
2^(704 - 64) = 2^640 instead of 2^704), judged by the cell's own check.

    python3 portbench/control.py --workload <cell> --seed <n> [--seed <n> ...] [--count N]

At the cell's own size on the card; a control that comes out correct is a
check that cannot fail.  For each seed it prints the numbers compared
beside their limits; the last line is a JSON object of every reading, and
the exit code is 0 when every seed's control came out not correct.  The
benchmark's runs do not run it.
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from portbench import harness  # noqa: E402


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--count", type=int, default=400, help="requests of the window it stands for")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = harness.Cell.find(harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    device = torch.device(args.device)
    q_bits = int(cell.cfg["logq"]) // 64 * 64 - 64
    first = int(cell.traffic["warm"])
    readings = []
    for seed in args.seed:
        t0 = time.perf_counter()
        ctx = harness.Context(cell, seed, device, harness.Spans(False, device))
        answers = harness.control_answers(ctx, range(first, first + args.count), q_bits)
        checks = cell.entry.judge(ctx, answers)
        failed = [name for name, v, limit in checks if v > limit]
        print(f"control {args.workload} seed {seed} (q = 2^{q_bits}): "
              + ", ".join(f"{n} {v} (limit {lim})" for n, v, lim in checks)
              + f"; {'not correct' if failed else 'CORRECT'} in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        readings.append({"seed": seed, "q_bits": q_bits, "correct": not failed,
                         "checks": {n: v for n, v, _ in checks}})
    print(json.dumps({"workload": args.workload, "readings": readings}))
    return 0 if not any(r["correct"] for r in readings) else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
