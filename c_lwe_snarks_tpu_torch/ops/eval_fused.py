"""Fused keystream kernels: eval_poly's MAC (K3) and setup's encrypt (K4).

Port of ``c_lwe_snarks_tpu/ops/eval_fused.py``.  Both kernels regenerate
the ciphertext a-vectors from the CRS keystream inside the kernel, so the
keystream (11.8 GB per protocol stage at release parameters) never
reaches device memory:

* ``eval_mac_planes`` (K3, ``csrc/eval_fused.cu``): for k coefficient
  vectors over ``d`` sequential ciphertexts, the byte-plane MACs
  out[c, k, coord, digit] = sum_i byte_c(coeff_k[i]) * a_i[coord, digit].
* ``encrypt_b_fused`` (K4): <sk, a_i> mod 2^704 for ``count`` sequential
  ciphertexts, as accumulator planes that ``carry_fold`` normalizes;
  ``encrypt_b_planes`` returns the kernel's two nibble plane arrays as
  they are, for ``digits.carry_fold_b_rows`` (K10's b-row form).

Ciphertext i of a section starts at stream byte offset + i * CTR_CT with
CTR_CT = 92n; of each 92-byte draw the low 88 bytes are digits and the
top 4 are dead (the mod-2^704 truncation).  The kernels write the
keystream tile to shared memory and contract it on the tensor cores
(``mma.sync`` on unsigned bytes, signed 32-bit sums), with the
conflict-free T-table cipher of ``csrc/aes_core_cf.cuh``.  The plain
versions expand the a-vectors chunk-wise and contract them with exact
float64 products.
"""

from __future__ import annotations

import torch

from ..utils import spans
from . import _build, aes
from . import digits as dg
from . import sampling

LAUNCHES = spans.count_launches({"eval_mac_planes": 0, "encrypt_b_fused": 0})
_PLAIN_ROWS = 32  # ciphertexts per plain-version chunk (bounds the float64 temporaries)


def _coeff_planes(coeffs: torch.Tensor) -> torch.Tensor:
    """int64 [k, d] words -> float64 [4 * k, d] byte planes, (byte, k) order."""
    k, d = coeffs.shape
    shifts = (torch.arange(4, device=coeffs.device) * 8)[:, None, None]
    return ((coeffs[None] >> shifts) & 255).reshape(4 * k, d).to(torch.float64)


def _expand_a_plain(key: sampling.PRGKey, byte_offset: int, count: int, n: int):
    """uint8 [count, n, 88] a-vectors from the plain keystream (no kernel)."""
    ks = aes.keystream_bytes_plain(key.aes, byte_offset, count * n * 92)
    return ks.reshape(count, n, 92)[..., : dg.DIGITS]


def eval_mac_planes_plain(
    key: sampling.PRGKey, section_offset: int, coeffs: torch.Tensor, n: int,
    ctr_ct: int,
) -> torch.Tensor:
    """Plain torch form of ``eval_mac_planes`` (same output)."""
    k, d = coeffs.shape
    cb = _coeff_planes(coeffs)
    out = torch.zeros(4 * k, n * dg.DIGITS, dtype=torch.int64, device=coeffs.device)
    for lo in range(0, d, _PLAIN_ROWS):
        rows = min(_PLAIN_ROWS, d - lo)
        a = _expand_a_plain(key, section_offset + lo * ctr_ct, rows, n)
        # each chunk's sums are < rows * 255^2: exact in float64
        out += (cb[:, lo : lo + rows] @ a.reshape(rows, -1).to(torch.float64)).to(torch.int64)
    return out.reshape(4, k, n, dg.DIGITS)


def eval_mac_planes(
    key: sampling.PRGKey, section_offset: int, coeffs: torch.Tensor, n: int,
    ctr_ct: int,
) -> torch.Tensor:
    """a-part MAC planes of k fused homomorphic evaluations (K3).

    coeffs: int64 [k, d] words.  Returns int64 [4, k, n, 88] with plane c
    holding sum_i byte_c(coeff_k[i]) * a_i[coord, digit] (exact).  The
    b-row MAC and the carry fold stay with the caller (models/lwe.py).
    """
    k, d = coeffs.shape
    assert ctr_ct == 92 * n and section_offset >= 0
    if coeffs.device.type == "cpu":
        return eval_mac_planes_plain(key, section_offset, coeffs, n, ctr_ct)
    if coeffs.device.type != "cuda" or key.device != coeffs.device:
        raise ValueError(f"coeffs on {coeffs.device}, key on {key.device}")
    _build.check_tensor(coeffs, torch.int64, (k, d), coeffs.device)
    if not 1 <= k <= 8:
        raise ValueError(f"the kernel takes 1..8 coefficient vectors, got {k}")
    out = torch.zeros(4, k, n, dg.DIGITS, dtype=torch.int64, device=coeffs.device)
    if d:
        c32 = _build.bits32(coeffs)
        _build.launch(
            "cls_eval_mac_planes", key.aes.tables32, key.aes.rk_param,
            key.aes.nonce_lo, key.aes.nonce_hi, section_offset, c32, k, d, n, out,
        )
        LAUNCHES["eval_mac_planes"] += 1
    return out


def encrypt_b_planes_plain(
    key: sampling.PRGKey, section_offset: int, sk: torch.Tensor, count: int,
    n: int, ctr_ct: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch form of ``encrypt_b_planes``: (v_lo, v_hi) as int64."""
    sk_lo = (sk & 15).to(torch.float64)
    sk_hi = (sk >> 4).to(torch.float64)
    lo_rows, hi_rows = [], []
    for lo in range(0, count, _PLAIN_ROWS):
        rows = min(_PLAIN_ROWS, count - lo)
        a = _expand_a_plain(key, section_offset + lo * ctr_ct, rows, n)
        at = a.to(torch.float64).transpose(1, 2)  # [rows, 88, n]
        lo_rows.append(dg.antidiag_sums((at @ sk_lo).to(torch.int64))[..., : dg.DIGITS])
        hi_rows.append(dg.antidiag_sums((at @ sk_hi).to(torch.int64))[..., : dg.DIGITS])
    if not lo_rows:
        empty = torch.zeros(0, dg.DIGITS, dtype=torch.int64, device=sk.device)
        return empty, empty.clone()
    return torch.cat(lo_rows), torch.cat(hi_rows)


def encrypt_b_fused_plain(
    key: sampling.PRGKey, section_offset: int, sk: torch.Tensor, count: int,
    n: int, ctr_ct: int,
) -> torch.Tensor:
    """Plain torch form of ``encrypt_b_fused`` (same output)."""
    return dg.nibble_dot_planes(*encrypt_b_planes_plain(key, section_offset, sk, count, n, ctr_ct))


def fits_enc_bound(n: int) -> bool:
    """Whether K4's per-digit nibble sums, at most n * 88 * 255 * 15, fit
    the tensor cores' signed 32-bit accumulators (n <= 6379)."""
    return n * 88 * 255 * 15 < 1 << 31


def check_enc_bound(n: int) -> None:
    """Raise unless ``fits_enc_bound(n)``."""
    if not fits_enc_bound(n):
        raise ValueError(f"n={n} overflows the kernel's signed 32-bit accumulators")


def encrypt_b_planes(
    key: sampling.PRGKey, section_offset: int, sk: torch.Tensor, count: int,
    n: int, ctr_ct: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's raw output for ``count`` sequential section ciphertexts: the
    nibble dot planes (v_lo, v_hi), each [count, 88], with sk split into
    nibbles, v_lo[t] = sum_{j, k+l=t} a_j[k] * (sk[j, l] & 15) and v_hi
    likewise with sk >> 4 (each < n * 88 * 255 * 15 < 2^31).

    sk: uint8 [n, 88].  On a CUDA tensor, one launch of K4, whose two int32
    arrays are returned as they are (``digits.carry_fold_b_rows`` reads
    them); on the CPU, ``encrypt_b_planes_plain`` (int64)."""
    assert ctr_ct == 92 * n and section_offset >= 0
    if sk.device.type == "cpu":
        return encrypt_b_planes_plain(key, section_offset, sk, count, n, ctr_ct)
    if sk.device.type != "cuda" or key.device != sk.device:
        raise ValueError(f"sk on {sk.device}, key on {key.device}")
    _build.check_tensor(sk, torch.uint8, (n, dg.DIGITS), sk.device)
    check_enc_bound(n)
    # zeroed: the kernel splits the draws over blocks and adds their sums
    v_lo = torch.zeros(count, dg.DIGITS, dtype=torch.int32, device=sk.device)
    v_hi = torch.zeros_like(v_lo)
    if count:
        _build.launch(
            "cls_encrypt_b_fused", key.aes.tables32, key.aes.rk_param,
            key.aes.nonce_lo, key.aes.nonce_hi, section_offset, sk, count, n,
            v_lo, v_hi,
        )
        LAUNCHES["encrypt_b_fused"] += 1
    return v_lo, v_hi


def encrypt_b_fused(
    key: sampling.PRGKey, section_offset: int, sk: torch.Tensor, count: int,
    n: int, ctr_ct: int,
) -> torch.Tensor:
    """<sk, a_i> mod 2^704 for ``count`` sequential section ciphertexts (K4).

    sk: uint8 [n, 88].  Returns int64 planes [count, 88] equal to the JAX
    package's (non-negative, <= 255 + ~2^21): ``digits.nibble_dot_planes``
    of ``encrypt_b_planes``.  The caller adds p * e + m and carry-folds
    (setup itself takes ``encrypt_b_planes`` into
    ``digits.carry_fold_b_rows``).
    """
    v_lo, v_hi = encrypt_b_planes(key, section_offset, sk, count, n, ctr_ct)
    return dg.nibble_dot_planes(v_lo, v_hi)
