"""One protocol stage at release parameters under ``torch.profiler``: its
wall, device-busy share, kernel launches and largest device items.

    python tools/profile_stage.py [--stage random_ssp|setup|verifier|prover ...]
                                  [--root CHECKOUT] [--label TEXT]

Needs a CUDA device.  ``--root`` names the checkout whose
``c_lwe_snarks_tpu_torch`` is imported (default: this one), so one call can
profile two trees with the same script.  It runs random_ssp, setup, the
prover and the verifier once at release parameters (the warm calls: the
kernel library, the tables, the allocator; their peak device memory is
printed, the SSP's type beside it), then for each ``--stage``
(default: setup and verifier) one traced call (after the profiler's 10 ms
settle) and five untraced calls, each timed on the host clock around a
synchronize.  Device busy = device items (kernels, copies, sets) over the
traced wall; launches = kernel items, copies and sets not counted.  The
last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from profile_prover import _summary, _trace  # noqa: E402

STAGES = ("random_ssp", "setup", "verifier", "prover")


def run(stages, label: str, file=sys.stdout) -> dict:
    """Profile the named release stages of the imported package; print and
    return the readings."""
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wits, ssp = tssp.random_ssp(ent_key, 0, P)
    crs, vrs = tsnark.setup(crs_key, ent_key, off_setup, ssp, P)
    proof = tsnark.prover(crs_key, ent_key, off_prove, crs, ssp, wits, P)
    if not bool(tsnark.verifier(vrs, ssp, proof, P)):
        raise RuntimeError("profile_stage: the verifier rejected the release proof")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"profile stage: the warm release run (random_ssp, setup, prover, verifier): peak "
          f"device memory {peak_gib:.3f} GiB, SSP v {ssp.v.dtype} [{label}]", file=file)
    calls = {
        "random_ssp": lambda: tssp.random_ssp(ent_key, 0, P),
        "setup": lambda: tsnark.setup(crs_key, ent_key, off_setup, ssp, P),
        "verifier": lambda: tsnark.verifier(vrs, ssp, proof, P),
        "prover": lambda: tsnark.prover(crs_key, ent_key, off_prove, crs, ssp, wits, P),
    }
    out = {"warm_peak_gib": peak_gib}
    for stage in stages:
        fn = calls[stage]
        items, wall = _trace(fn)
        summary = _summary(items, wall)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        by_name = sorted(((name, us, c) for name, (us, c) in items.items()), key=lambda x: -x[1])
        print(f"profile stage: {stage} under the profiler {summary['wall_s']:.6f} s, device busy "
              f"{summary['device_busy_ms']:.3f} ms ({100 * summary['busy_share']:.1f} %), "
              f"{summary['kernel_launches']} kernel launches, {summary['h2d_copies']} "
              f"host-to-device and {summary['d2h_copies']} device-to-host copies; 5 untraced: "
              f"{', '.join(f'{x:.6f}' for x in walls)} s [{label}]", file=file)
        for name, us, count in by_name[:10]:
            print(f"profile stage:   {stage} x{count:<5d} {us / 1e3:9.3f} ms  {name[:90]}", file=file)
        out[stage] = {**summary, "untraced_walls_s": walls,
                      "items": [[n, us, c] for n, us, c in by_name[:10]]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", action="append", choices=STAGES,
                    help="a stage to profile (repeatable; default: setup and verifier)")
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_stage: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    out = run(args.stage or ("setup", "verifier"), args.label or torch.cuda.get_device_name(0))
    print(json.dumps({"root": args.root, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
