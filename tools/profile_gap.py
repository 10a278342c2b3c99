"""How many of a burst of kernel launches ``torch.profiler`` traces, by
how long the burst waits after the profiler starts.

    python tools/profile_gap.py [--trials 8] [--launches 20]

Needs a CUDA device.  Each trial opens a profiler window, waits ``settle``
milliseconds (0, 1, 10 or 50, in turns), launches K1 (the raw keystream,
``aes.keystream_blocks``) at 1 and at 382,292 blocks ``--launches`` times
each, synchronizes and closes the window.  It prints, per setting, the
kernel launches the trace holds against those the wrapper counted
(``aes.LAUNCHES``), and the ``cudaLaunchKernel`` calls the trace holds on
the host side.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
SETTLE_MS = (0, 1, 10, 50)


def burst(key, settle_ms: float, nblocks: int, launches: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from c_lwe_snarks_tpu_torch.ops import aes

    torch.cuda.synchronize()
    before = aes.LAUNCHES["keystream_words"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(settle_ms / 1e3)
        for _ in range(launches):
            aes.keystream_blocks(key, 0, nblocks)
        torch.cuda.synchronize()
    launched = aes.LAUNCHES["keystream_words"] - before
    names = [ev.name for ev in prof.events()]
    return {"launched": launched,
            "traced_kernels": sum("keystream_blocks_kernel" in n for n in names),
            "traced_launch_calls": sum(n == "cudaLaunchKernel" for n in names)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_gap: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from c_lwe_snarks_tpu_torch.ops import aes

    key = aes.make_key(bytes(range(40)), "cuda")
    aes.keystream_blocks(key, 0, 1)  # build and load the kernels
    torch.cuda.synchronize()
    rows = []
    for trial in range(args.trials):
        for settle in SETTLE_MS:
            for nblocks in (1, 382_292):
                r = burst(key, settle, nblocks, args.launches)
                rows.append({"trial": trial, "settle_ms": settle, "nblocks": nblocks, **r})
    summary = {}
    for settle in SETTLE_MS:
        sel = [r for r in rows if r["settle_ms"] == settle]
        summary[settle] = {
            "bursts": len(sel),
            "bursts_short": sum(r["traced_kernels"] < r["launched"] for r in sel),
            "kernels_traced": sum(r["traced_kernels"] for r in sel),
            "launched": sum(r["launched"] for r in sel),
            "launch_calls_traced": sum(r["traced_launch_calls"] for r in sel),
        }
        print(f"settle {settle:>2} ms: {summary[settle]}")
    for r in rows:
        if r["traced_kernels"] < r["launched"]:
            print(f"short burst: {r}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "summary": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
