"""Observability: stage timers, a profiler hook and the decrypt-probes.

Port of ``c_lwe_snarks_tpu/utils/obs.py``.  PyTorch returns before a CUDA
launch finishes, so ``timeit`` calls ``torch.cuda.synchronize()`` before
starting and before stopping; a stage's time then covers its device work.
The designated-verifier decrypt-probe is the reference's de-facto
debugging tool: decrypt intermediate ciphertexts mid-protocol and check
algebraic invariants mod p (src/test_snark.c:40-70).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

from ..models import lwe as tlwe
from ..models import snark as tsnark
from ..ops import modp, sampling
from .params import Params


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timeit(name: str, device="cuda", *, out: dict | None = None, file=sys.stderr):
    """Time a block on ``device``; store seconds in ``out[name]`` if given."""
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    if out is not None:
        out[name] = dt
    print(f"[timeit] {name}: {dt:.6f}s", file=file)


@contextlib.contextmanager
def profile(logdir: str):
    """torch.profiler trace (CPU and CUDA activities) around a block.

    Writes ``trace.json`` (chrome trace format) into ``logdir`` and yields
    the profiler, whose ``key_averages()`` hold the sums by kernel."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    print(f"[profile] trace written to {logdir}", file=sys.stderr)


# --------------------------------------------------------------------------
# Decrypt-probes (designated-verifier observability, src/test_snark.c:40-70)
# --------------------------------------------------------------------------


def probe_compressed(
    crs_key: sampling.PRGKey,
    section_offset: int,
    b_rows: torch.Tensor,
    sk: torch.Tensor,
    params: Params,
) -> torch.Tensor:
    """Decrypt compressed CRS rows: int64 [count] plaintexts mod p.

    The reference probe pattern: seek to the section offset, ct_import,
    decrypt (src/test_snark.c:44-49)."""
    cts = tlwe.ct_import(crs_key, section_offset, b_rows, params)
    return tlwe.decrypt(cts, sk, params)


def probe_crs(crs: tsnark.CRS, vrs: tsnark.VRS, params: Params) -> dict:
    """Decrypt the head and tail of the s and as sections and check them.

    Returns a dict of bool scalars: Dec(s[0]) == 1, Dec(as[0]) == alpha,
    Dec(s[1]) == s, Dec(s[d-1]) == s^(d-1), and the alpha-correlation
    Dec(as[i]) == alpha * Dec(s[i]) at i = 1 and d-1
    (src/test_snark.c:48-60).  Each row is imported at its exact stream
    offset."""
    key = sampling.PRGKey(crs.seed, crs.b_s.device)
    d = params.d
    idx = (0, 1, d - 1)
    alpha, s = modp.words(vrs.alpha), modp.words(vrs.s)  # the VRS holds uint32
    dec_s = torch.stack([
        probe_compressed(key, params.ctr_s + i * params.ctr_ct, crs.b_s[i][None], vrs.sk, params)[0]
        for i in idx])
    dec_as = torch.stack([
        probe_compressed(key, params.ctr_as + i * params.ctr_ct, crs.b_as[i][None], vrs.sk, params)[0]
        for i in idx])
    return {
        "s0_is_one": dec_s[0] == 1,
        "as0_is_alpha": dec_as[0] == alpha,
        "alpha_correlated_1": modp.mulmod_p(alpha, dec_s[1]) == dec_as[1],
        "alpha_correlated_last": modp.mulmod_p(alpha, dec_s[2]) == dec_as[2],
        "s1_is_s": dec_s[1] == s,
        "s_power_last": modp.powmod_p(s, d - 1) == dec_s[2],
    }


def probe_proof(pi: tsnark.Proof, vrs: tsnark.VRS, params: Params) -> dict:
    """Decrypt the proof terms and check alpha * h_s == hat_h_s
    (src/test_snark.c:81-89)."""
    dec = tlwe.decrypt(pi.stack(), vrs.sk, params)
    return {
        "h": dec[0], "hat_h": dec[1], "hat_v": dec[2], "v_w": dec[3], "b_w": dec[4],
        "pke_h": modp.mulmod_p(vrs.alpha, dec[0]) == dec[1],
    }


def probe_crs_range(
    crs: tsnark.CRS,
    vrs: tsnark.VRS,
    params: Params,
    *,
    lo: int = 0,
    count: int | None = None,
) -> dict:
    """Batched CRS invariant check over the terms [lo, lo + count).

    One ct_import + decrypt batch per section, then
    Dec(as[i]) == alpha * Dec(s[i]) for every probed i and the geometric
    chain Dec(s[i+1]) == s * Dec(s[i]); all on the device."""
    if count is None:
        count = min(params.d - lo, 256)
    key = sampling.PRGKey(crs.seed, crs.b_s.device)
    dec_s = probe_compressed(
        key, params.ctr_s + lo * params.ctr_ct, crs.b_s[lo : lo + count], vrs.sk, params)
    dec_as = probe_compressed(
        key, params.ctr_as + lo * params.ctr_ct, crs.b_as[lo : lo + count], vrs.sk, params)
    out = {
        "alpha_correlated_all": torch.all(modp.mulmod_p(vrs.alpha, dec_s) == dec_as),
        "s_chain_all": torch.all(modp.mulmod_p(vrs.s, dec_s[:-1]) == dec_s[1:]),
    }
    if lo == 0:
        out["s0_is_one"] = dec_s[0] == 1
        out["as0_is_alpha"] = dec_as[0] == modp.words(vrs.alpha)
    return out
