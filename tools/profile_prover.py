"""The prover at release parameters under ``torch.profiler``: its wall and
device-busy share, and what its polynomial stage (``prover_polys``)
launches on the card, by kernel name.

    python tools/profile_prover.py [--root CHECKOUT] [--label TEXT]

Needs a CUDA device.  ``--root`` names the checkout whose
``c_lwe_snarks_tpu_torch`` is imported (default: this one), so one call
can profile two trees with the same script.  It runs random_ssp and setup
at release parameters, one warm prover, then one traced ``prover`` and
one traced ``prover_polys`` (each after the profiler's 10 ms settle), then
five untraced ``prover_polys`` and five untraced ``prover``, each timed on
the host clock around a synchronize.  Device-busy share = device items
(kernels, copies, sets) over the traced wall.  ``chip_smoke.py``'s profile phase calls ``run``.
The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

SETTLE_S = 0.01  # the profiler traces no kernel in its first ~1 ms (chip_smoke.py:device_times)


def _trace(fn) -> tuple[dict, float]:
    """({device item name: (microseconds, count)}, host seconds) of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(SETTLE_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    items = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            items[ev.key] = (ev.self_cuda_time_total if us is None else us, ev.count)
    return items, wall


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _summary(items: dict, wall: float) -> dict:
    busy = sum(us for us, _ in items.values())
    return {
        "wall_s": wall,
        "device_busy_ms": busy / 1e3,
        "busy_share": busy / 1e6 / wall,
        "kernel_launches": sum(c for name, (_, c) in items.items() if not _is_copy(name)),
        "h2d_copies": sum(c for name, (_, c) in items.items() if "HtoD" in name),
        "d2h_copies": sum(c for name, (_, c) in items.items() if "DtoH" in name),
    }


def run(label: str, file=sys.stdout) -> dict:
    """Profile the release prover of the imported package; print and return
    the readings."""
    import torch

    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import sampling
    from c_lwe_snarks_tpu_torch.utils.params import release

    P = release()
    crs_key = sampling.PRGKey(bytes(40), "cuda")
    ent_key = sampling.PRGKey(bytes([1] * 40), "cuda")
    off_setup = tssp.entropy_bytes_random_ssp(P)
    off_prove = off_setup + tsnark.setup_entropy_bytes(P)
    wits, ssp = tssp.random_ssp(ent_key, 0, P)
    crs, _ = tsnark.setup(crs_key, ent_key, off_setup, ssp, P)

    def prove():
        return tsnark.prover(crs_key, ent_key, off_prove, crs, ssp, wits, P)

    def polys():
        return tsnark.prover_polys(ent_key, off_prove, ssp, wits, P)

    prove()  # warm: the kernel library, the tables, the allocator
    items, wall = _trace(prove)
    prover = _summary(items, wall)
    items, wall = _trace(polys)
    stage = _summary(items, wall)
    by_name = sorted(((name, us, c) for name, (us, c) in items.items()), key=lambda x: -x[2])

    def untraced(fn) -> list:
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return walls

    walls, prover_walls = untraced(polys), untraced(prove)
    print(f"profile prover: one release prover under the profiler {prover['wall_s']:.6f} s, device "
          f"busy {prover['device_busy_ms']:.3f} ms ({100 * prover['busy_share']:.1f} %), "
          f"{prover['kernel_launches']} kernel launches, {prover['h2d_copies']} host-to-device and "
          f"{prover['d2h_copies']} device-to-host copies; 5 untraced: "
          f"{', '.join(f'{x:.6f}' for x in prover_walls)} s [{label}]", file=file)
    print(f"profile prover: prover_polys under the profiler {stage['wall_s']:.6f} s, device busy "
          f"{stage['device_busy_ms']:.3f} ms ({100 * stage['busy_share']:.1f} %), "
          f"{stage['kernel_launches']} kernel launches, {stage['h2d_copies']} host-to-device and "
          f"{stage['d2h_copies']} device-to-host copies; 5 untraced: "
          f"{', '.join(f'{x:.6f}' for x in walls)} s [{label}]", file=file)
    for name, us, count in by_name[:12]:
        print(f"profile prover:   prover_polys x{count:<5d} {us / 1e3:9.3f} ms  {name[:90]}",
              file=file)
    return {"prover": {**prover, "untraced_walls_s": prover_walls},
            "prover_polys": {**stage, "untraced_walls_s": walls,
                             "items": [[n, us, c] for n, us, c in by_name]}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_prover: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    out = run(args.label or torch.cuda.get_device_name(0))
    print(json.dumps({"root": args.root, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
