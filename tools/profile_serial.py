"""Host time of the artifacts layer's calls at release shapes on the card,
untraced: each call after a synchronize, on the host clock.

    python tools/profile_serial.py [--root CHECKOUT] [--calls N]

Needs a CUDA device.  ``--root`` names the checkout whose
``c_lwe_snarks_tpu_torch`` is imported (default: this one), so one call can
time two trees with the same script.  The CRS, VRS and proof hold random
digits made on the card.  A writer's time includes its copy to the host; a
reader's is timed twice, as it returns and with its copy to the card
synchronized.  The first 20 calls of each are left out; the line printed
is one JSON object: {call: [median, first quartile, third quartile]} in
microseconds.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time


def timed(fn, calls: int, sync_after: bool, torch) -> list:
    out = []
    for _ in range(calls + 20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync_after:
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e6)
    q1, q2, q3 = statistics.quantiles(out[20:], n=4)
    return [round(q2, 1), round(q1, 1), round(q3, 1)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    ap.add_argument("--calls", type=int, default=280)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from c_lwe_snarks_tpu_torch.models import snark
    from c_lwe_snarks_tpu_torch.utils import serial
    from c_lwe_snarks_tpu_torch.utils.params import release

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    P, dev = release(), torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def digits(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=g)

    def word(x):
        return torch.tensor(x, dtype=torch.uint32, device=dev)

    crs = snark.CRS(seed=bytes(range(40)), b_s=digits(P.d, 88), b_as=digits(P.d, 88),
                    b_t=digits(88), b_v=digits(P.m - 1, 88))
    vrs = snark.VRS(alpha=word(123456789), beta=word(3141592653), s=word(77),
                    sk=digits(P.n, 88))
    pi = snark.Proof(*(digits(P.n + 1, 88) for _ in range(5)))
    blob = serial.proof_to_bytes(pi, P)
    calls = {
        "crs_to_bytes": (lambda: serial.crs_to_bytes(crs, P), False),
        "vrs_to_bytes": (lambda: serial.vrs_to_bytes(vrs, P), False),
        "proof_to_bytes": (lambda: serial.proof_to_bytes(pi, P), False),
        "proof_from_bytes": (lambda: serial.proof_from_bytes(blob, P, dev), False),
        "proof_from_bytes+sync": (lambda: serial.proof_from_bytes(blob, P, dev), True),
    }
    out = {name: timed(fn, args.calls, s, torch) for name, (fn, s) in calls.items()}
    print(json.dumps({"root": args.root, "device": torch.cuda.get_device_name(0), **out}))


if __name__ == "__main__":
    main()
