"""K6's Newton launch on the card: its device time level by level, and the
release division at each crossover N_c, to choose N_c (``ntt.NEWTON_N``).

    python tools/k6_crossover.py [--root CHECKOUT]

Needs a CUDA device.  At release parameters (d = 2^15, t from random_ssp,
num = v^2 - 1 from the prover's v), under ``torch.profiler``:

1. the Newton launch alone with 1 .. 13 levels (n = 2 ... 16,384): device
   microseconds a launch, mean of 20 launches;
2. the release division h = (v^2 - 1) / t at N_c = 4,096, 8,192 and 16,384,
   in the order A B C C B A: device time of its K6 kernels and of all its
   kernels a call (mean of 10 calls), and the median host wall of 20
   untraced calls (host clock around a synchronize).

The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from profile_prover import _trace  # noqa: E402

CROSSOVERS = (4096, 8192, 16384)


def run(file=sys.stdout) -> dict:
    import torch

    from c_lwe_snarks_tpu_torch.models import snark as tsnark
    from c_lwe_snarks_tpu_torch.models import ssp as tssp
    from c_lwe_snarks_tpu_torch.ops import modp, ntt, sampling
    from c_lwe_snarks_tpu_torch.utils.params import release

    P = release()
    ent_key = sampling.PRGKey(bytes([1] * 40), "cuda")
    wits, ssp = tssp.random_ssp(ent_key, 0, P)
    off = tssp.entropy_bytes_random_ssp(P) + tsnark.setup_entropy_bytes(P)
    v = tsnark.prover_polys(ent_key, off, ssp, wits, P)[2]
    num = ntt.poly_mul_mod_p(v, v)
    num[0] = modp.submod_p(num[0], 1)
    degree, lead = ntt.poly_degree_and_lead(ssp.t)
    t_rev = torch.flip(ssp.t, (0,))[None].contiguous()
    seed = pow(lead, modp.P - 2, modp.P)

    def k6_us(items: dict, calls: int, names=("ntt_",)) -> float:
        return sum(us for name, (us, _) in items.items() if any(k in name for k in names)) / calls

    levels_us = {}
    for lv in range(1, 14):
        n = 2 if lv == 1 else 1 << (lv + 1)
        N = max(n, 4)
        ntt._k6_newton(t_rev, None, seed, lv, N)
        items, _ = _trace(lambda: [ntt._k6_newton(t_rev, None, seed, lv, N) for _ in range(20)])
        levels_us[lv] = k6_us(items, 20, ("ntt_newton",))
        print(f"k6 crossover: Newton launch, {lv} levels (n up to {n}): "
              f"{levels_us[lv]:.3f} us device a launch", file=file)

    def divide(nc):
        old = ntt.NEWTON_N
        ntt.NEWTON_N = nc
        try:
            return ntt.poly_div_exact_mod_p(num, ssp.t, P.d, den_degree=degree, den_lead=lead)
        finally:
            ntt.NEWTON_N = old

    want = divide(4096)
    division = {nc: {"k6_device_us": [], "device_us": [], "wall_s": []} for nc in CROSSOVERS}
    for nc in CROSSOVERS + CROSSOVERS[::-1]:
        got = divide(nc)
        if not torch.equal(got, want):
            raise RuntimeError(f"k6 crossover: the division at N_c = {nc} differs")
        items, _ = _trace(lambda: [divide(nc) for _ in range(10)])
        division[nc]["k6_device_us"].append(k6_us(items, 10))
        division[nc]["device_us"].append(sum(us for us, _ in items.values()) / 10)
        walls = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            divide(nc)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        division[nc]["wall_s"].append(statistics.median(walls))
    for nc, r in division.items():
        print(f"k6 crossover: release division at N_c = {nc}: K6 device "
              f"{', '.join(f'{x:.3f}' for x in r['k6_device_us'])} us, all kernels "
              f"{', '.join(f'{x:.3f}' for x in r['device_us'])} us a call; untraced median wall "
              f"{', '.join(f'{x:.6f}' for x in r['wall_s'])} s", file=file)
    return {"newton_levels_us": levels_us, "division": division}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k6_crossover: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    out = run()
    print(json.dumps({"root": args.root, "device": torch.cuda.get_device_name(0), **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
