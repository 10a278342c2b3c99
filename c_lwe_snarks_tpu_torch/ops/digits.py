"""Base-256 digit arithmetic mod 2^704 on torch tensors.

Port of ``c_lwe_snarks_tpu/ops/digits.py``.  A mod-2^704 integer is a row
of 88 little-endian uint8 digits; a batch of them is a 2D tensor.
Accumulator planes are int64 (weight 256^k at position k), so the int32
headroom arguments of the JAX package become plain bounds below 2^47.

Byte contractions run as float64 matrix products, exact while every
partial sum is < 2^53 (K * 255^2 < 2^53 for any contraction length K
here).  The unsigned operands need none of the MXU's int8 recentring.

On a CUDA tensor the carry fold is K10 (``csrc/digits.cu``), also in its
b-row form (``carry_fold_b_rows``, setup's b = <sk, a> + p * e + m from
K4's planes); ``LAUNCHES`` counts its launches.  The CPU takes the plain
versions, ``carry_fold_plain`` and ``b_rows_plain``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

DIGITS = 88  # mod-2^704 width in base-256 digits
FULL_DIGITS = 92  # PRG bytes per sampled value (LOGQ_BYTES, src/lwe.h:29)

LAUNCHES = {"carry_fold": 0}
_P = (1 << 32) - 5


# --------------------------------------------------------------------------
# Host conversions (tests and constants).
# --------------------------------------------------------------------------


def int_to_digits(x: int, ndigits: int = DIGITS) -> np.ndarray:
    assert 0 <= x < 1 << (8 * ndigits)
    return np.frombuffer(x.to_bytes(ndigits, "little"), dtype=np.uint8).copy()


def digits_to_int(d) -> int:
    if isinstance(d, torch.Tensor):
        d = d.cpu().numpy()
    return int.from_bytes(np.asarray(d, dtype=np.uint8).tobytes(), "little")


def ints_to_digit_matrix(xs, ndigits: int = DIGITS) -> np.ndarray:
    return np.stack([int_to_digits(x, ndigits) for x in xs])


# --------------------------------------------------------------------------
# Carry folding: int64 accumulator planes -> normalized uint8 digits.
# --------------------------------------------------------------------------


def partial_fold(v: torch.Tensor) -> torch.Tensor:
    """One shift-add carry pass over the last axis (weight-preserving
    mod 256^K): positions drop from < 2^b to <= 255 + 2^(b-8)."""
    out = v & 255
    out[..., 1:] += v[..., :-1] >> 8
    return out


def carry_fold_plain(acc: torch.Tensor, ndigits: int = DIGITS) -> torch.Tensor:
    """K10's plain version: normalize non-negative planes (each < 2^47).

    Returns the value mod 256^ndigits as uint8 [..., ndigits] (planes
    [..., K] with K < ndigits are zero-extended first).  Six shift-add
    passes bring every position to <= 256; the remaining one-bit ripple is
    resolved by carry lookahead: position t receives a carry iff the
    nearest position below it that is not 255 holds 256.
    """
    x = acc.to(torch.int64)
    if x.shape[-1] < ndigits:
        x = F.pad(x, (0, ndigits - x.shape[-1]))
    for _ in range(6):  # 2^47 -> 2^39 -> 2^31 -> 2^23 -> 2^15 -> 2^7+255 -> 256
        x = partial_fold(x)
    iota = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    none = torch.full_like(x, -1)
    g_idx = torch.cummax(torch.where(x == 256, iota, none), dim=-1).values
    b_idx = torch.cummax(torch.where(x <= 254, iota, none), dim=-1).values
    carry_in = torch.zeros_like(x)
    carry_in[..., 1:] = (g_idx > b_idx)[..., :-1].to(torch.int64)
    return ((x + carry_in) & 255)[..., :ndigits].to(torch.uint8)


def carry_fold(acc: torch.Tensor, ndigits: int = DIGITS) -> torch.Tensor:
    """Normalize non-negative planes [..., K] to uint8 digits [..., ndigits]:
    the value sum_t acc[..., t] * 256^t mod 256^ndigits.

    K10: on a CUDA tensor, one launch of ``csrc/digits.cu`` (int64 or int32
    planes, any non-negative value); on the CPU, ``carry_fold_plain``
    (planes < 2^47)."""
    if acc.device.type == "cpu":
        return carry_fold_plain(acc, ndigits)
    k = acc.shape[-1]
    assert k >= 1 and ndigits >= 1
    x = acc if acc.dtype in (torch.int64, torch.int32) else acc.to(torch.int64)
    x = x.contiguous()
    out = torch.empty(*acc.shape[:-1], ndigits, dtype=torch.uint8, device=acc.device)
    rows = x.numel() // k
    if rows:
        _build.launch("cls_carry_fold", x, int(x.dtype == torch.int32), rows, k, ndigits, out)
        LAUNCHES["carry_fold"] += 1
    return out


def b_rows_plain(v_lo: torch.Tensor, v_hi: torch.Tensor, errs: torch.Tensor,
                 msgs: torch.Tensor) -> torch.Tensor:
    """The b-row form's plain version: K4's nibble planes to the JAX
    package's dot planes (``nibble_dot_planes``), plus p * e and m as
    planes (``pe_m_planes``), then the carry fold."""
    return carry_fold_plain(nibble_dot_planes(v_lo, v_hi) + pe_m_planes(msgs, errs))


def carry_fold_b_rows(v_lo: torch.Tensor, v_hi: torch.Tensor, errs: torch.Tensor,
                      msgs: torch.Tensor) -> torch.Tensor:
    """setup's b-rows <sk, a> + p * e + m mod 2^704 as uint8 [B, 88].

    v_lo, v_hi: K4's nibble dot planes [B, 88] (int32 from the kernel;
    ``eval_fused.encrypt_b_planes``); errs: uint8 [B, 88]; msgs: int64
    words [B].  K10's b-row form: on a CUDA tensor one launch that stages
    each position's v_lo + 16 v_hi and error byte, adds p * e (p's four
    bytes) and m's bytes as it walks the row's carry; inputs must be
    contiguous there, of these types and shapes (else ValueError).  On the
    CPU, ``b_rows_plain``."""
    if v_lo.device.type == "cpu":
        return b_rows_plain(v_lo, v_hi, errs, msgs)
    rows = msgs.shape[0]
    for name, t, dtype, shape in (("v_lo", v_lo, torch.int32, (rows, DIGITS)),
                                  ("v_hi", v_hi, torch.int32, (rows, DIGITS)),
                                  ("errs", errs, torch.uint8, (rows, DIGITS)),
                                  ("msgs", msgs, torch.int64, (rows,))):
        try:
            _build.check_tensor(t, dtype, shape, v_lo.device)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
    out = torch.empty(rows, DIGITS, dtype=torch.uint8, device=v_lo.device)
    if rows:
        _build.launch("cls_carry_fold_b_rows", v_lo, v_hi, errs, msgs, rows, DIGITS, out)
        LAUNCHES["carry_fold"] += 1
    return out


# --------------------------------------------------------------------------
# Exact byte matmul.
# --------------------------------------------------------------------------


def u8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact unsigned a @ b for byte operands: a [..., M, K], b [K, N].

    Returns int64 [..., M, N].  float64 is exact for K * 255^2 < 2^53.
    """
    assert a.shape[-1] * 255 * 255 < 1 << 53
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


# --------------------------------------------------------------------------
# Big-int dot product: <a, b> mod 2^704 over a contraction axis.
# --------------------------------------------------------------------------


def antidiag_sums(p: torch.Tensor) -> torch.Tensor:
    """out[..., t] = sum_k p[..., k, t-k] for t < 2K-1 (skew reshape)."""
    *batch, kk, w = p.shape
    assert w == kk
    flat = F.pad(p, (0, kk)).reshape(*batch, kk * 2 * kk)
    skew = flat[..., : kk * (2 * kk - 1)].reshape(*batch, kk, 2 * kk - 1)
    return skew.sum(-2)


def bigint_dot_acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Planes of sum_i a_i * b_i truncated to digits < DIGITS.

    a: uint8 [..., n, DIGITS]; b: uint8 [n, DIGITS].  Returns int64
    [..., DIGITS]; the same planes as the JAX package (digit-product
    matrix split into low byte and high part, then anti-diagonal sums).
    """
    n, k = b.shape
    assert a.shape[-2:] == (n, k) and k == DIGITS
    p = u8_matmul(a.transpose(-1, -2), b)  # [..., K, K]
    p_comb = p & 255
    p_comb[..., 1:] += p[..., :-1] >> 8
    return antidiag_sums(p_comb)[..., :k]


def bigint_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> mod 2^704 as uint8 digits [..., DIGITS]."""
    return carry_fold(bigint_dot_acc(a, b))


def coeff_mac_acc(coeff_bytes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Byte-plane multiply-accumulate of the scan evaluation path.

    coeff_bytes: uint8 [T, C] (C byte planes of T coefficients); x: uint8
    [T, X] (T ciphertext rows).  Returns int64 [C, X]:
    out[c] = sum_t coeff_bytes[t, c] * x[t]."""
    return u8_matmul(coeff_bytes.T, x)


def combine_shift_planes(planes: torch.Tensor) -> torch.Tensor:
    """out[.., t] = sum_c planes[c][.., t-c] (values shifted past K-1 drop).

    planes: int64 [C, ..., K].  Each plane is split into its low byte and
    high part (shifted one more position), as in the JAX package.
    """
    lo = planes & 255
    hi = planes >> 8
    k = planes.shape[-1]

    def shift(v, s):
        return v if s == 0 else F.pad(v[..., : k - s], (s, 0))

    out = torch.zeros(planes.shape[1:], dtype=torch.int64, device=planes.device)
    for c in range(planes.shape[0]):
        out = out + shift(lo[c], c) + shift(hi[c], c + 1)
    return out


@functools.cache
def p_bytes(device) -> torch.Tensor:
    """int64 [4]: p's little-endian bytes, on the device once."""
    return torch.tensor([(_P >> (8 * i)) & 255 for i in range(4)], device=device)


def nibble_dot_planes(v_lo: torch.Tensor, v_hi: torch.Tensor) -> torch.Tensor:
    """K4's nibble dot planes -> the JAX package's <sk, a> planes:
    partial_fold(v_lo + 16 * partial_fold(v_hi)), int64 (<= 255 + ~2^21)."""
    hi_f = partial_fold(v_hi.to(torch.int64))  # <= 255 + 2^21
    return partial_fold(v_lo.to(torch.int64) + 16 * hi_f)


def pe_m_planes(msgs: torch.Tensor, errs: torch.Tensor) -> torch.Tensor:
    """p * e + m as int64 planes [B, 88] (< 2^26 a position): errs uint8
    [B, 88] times p's bytes, shifted, plus the message words' four bytes."""
    pe = combine_shift_planes(errs.to(torch.int64)[None] * p_bytes(errs.device).reshape(4, 1, 1))
    shifts = torch.arange(4, device=msgs.device) * 8
    m = (msgs[..., None] >> shifts) & 255
    return pe + F.pad(m, (0, pe.shape[-1] - 4))


# --------------------------------------------------------------------------
# Elementwise digit ops.
# --------------------------------------------------------------------------


def add_digits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2^704 digitwise."""
    return carry_fold(a.to(torch.int64) + b.to(torch.int64))


def sub_digits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod 2^704 via the base-256 complement a + (255 - b) + 1."""
    acc = a.to(torch.int64) + (255 - b.to(torch.int64))
    acc[..., 0] += 1
    return carry_fold(acc)


def select_digits(pred: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise where over digit rows; pred broadcast over the digit axis."""
    return torch.where(pred[..., None], x, y)


def digits_ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b as unsigned big-ints over LE digit rows (broadcasting)."""
    d = a.to(torch.int64) - b.to(torch.int64)
    iota = torch.arange(d.shape[-1], device=d.device)
    gt_idx = torch.where(d > 0, iota, -1).amax(-1)
    lt_idx = torch.where(d < 0, iota, -1).amax(-1)
    return gt_idx >= lt_idx  # equal (both -1) counts as >=


def scalar_mul_digits(a: torch.Tensor, c_bytes: torch.Tensor) -> torch.Tensor:
    """(a * c) mod 2^704 for a 32-bit scalar c given as 4 LE bytes."""
    c = c_bytes.to(torch.int64).reshape((4,) + (1,) * a.dim())
    return carry_fold(combine_shift_planes(a.to(torch.int64)[None] * c))


# --------------------------------------------------------------------------
# mod-p fold: digits -> residue mod p = 2^32 - 5.
# --------------------------------------------------------------------------


def mod_p(digits: torch.Tensor) -> torch.Tensor:
    """Value of uint8 digit rows mod p, as int64 [...].

    sum_k d_k * (256^k mod p): each term < 2^40, 88 of them < 2^47.
    """
    w = _radix_mod_p(digits.shape[-1], digits.device)
    return (digits.to(torch.int64) * w).sum(-1) % _P


@functools.cache
def _radix_mod_p(k: int, device) -> torch.Tensor:
    """int64 [k]: 256^i mod p, on the device once."""
    return torch.tensor([pow(256, i, _P) for i in range(k)], device=device)


def sub_mod_p(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for a, b < p."""
    return (a - b) % _P
