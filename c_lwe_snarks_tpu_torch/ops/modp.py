"""Z_p arithmetic for p = 2^32 - 5 on int64 tensors.

Port of ``c_lwe_snarks_tpu/ops/modp.py``.  torch has no uint32 shifts,
adds or compares, so a 32-bit word lives in an int64 tensor holding a
value in [0, 2^32).  Every product below is split so that no
intermediate reaches 2^63, and every result is the canonical residue in
[0, p) — the same value the JAX package computes with its uint32 tricks
(including ``add_u32_mod_p``'s double-wrap window, which exact int64
arithmetic covers by construction).

``matvec_mod_p`` and the plain version of the gated row-sum run as
float64 matrix products: torch refuses integer ``mm`` on CUDA, and a
float64 sum of integers is exact while every partial sum stays below
2^53, which the operand splits here guarantee.  On a CUDA tensor the
gated row-sum is K7 (``csrc/rowsum.cu``); ``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

import torch

from . import _build

P = (1 << 32) - 5  # plaintext modulus (GAMMA_P)

# rows per float64 chunk in the contractions: bounds the temporary at
# CHUNK x d x 8 bytes (256 MiB at d = 2^15)
_CHUNK = 1024
# rows a CUDA block of K7 sums (csrc/rowsum.cu: kChunkRows, also its columns)
ROWSUM_CHUNK_ROWS = 256

LAUNCHES = {"gated_rowsum_p": 0}


def mul32(a, b):
    """Exact 32x32 -> 64-bit product of words in [0, 2^32) as (hi, lo) words."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1  # each < 2^32
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)  # < 3 * 2^16
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def mulmod_p(a, b):
    """(a * b) mod p for words a, b in [0, 2^32) (tensors or ints)."""
    # a * (b >> 16) < 2^48 and a * (b & 0xFFFF) < 2^48: no int64 overflow
    return ((a * (b >> 16)) % P * 65536 + a * (b & 0xFFFF)) % P


def addmod_p(a, b):
    """(a + b) mod p for words in [0, 2^32)."""
    return (a + b) % P


def add_u32_mod_p(a, b):
    """(a + b) mod p for two arbitrary words (exact, no double wrap)."""
    return (a + b) % P


def submod_p(a, b):
    """(a - b) mod p (torch's ``%`` takes the sign of the divisor)."""
    return (a - b) % P


def fold64_mod_p(hi, lo):
    """(hi * 2^32 + lo) mod p, using 2^32 = 5 (mod p)."""
    return (hi * 5 + lo) % P


def bytes_to_u64_mod_p(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 8] little-endian words -> value mod p (rand_modp)."""
    w = b.to(torch.int64)
    shifts = torch.arange(4, device=b.device) * 8
    lo = (w[..., :4] << shifts).sum(-1)
    hi = (w[..., 4:] << shifts).sum(-1)
    return fold64_mod_p(hi, lo)


def powmod_p(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e mod p, static exponent (square and multiply)."""
    result = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            result = mulmod_p(result, base)
        e >>= 1
        if e:
            base = mulmod_p(base, base)
    return result


def invmod_p(a: torch.Tensor) -> torch.Tensor:
    """a^-1 mod p via Fermat (p prime)."""
    return powmod_p(a, P - 2)


def sum_mod_p(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Sum mod p along an axis; entries < p, fewer than 2^31 of them."""
    return x.sum(axis) % P


def powers_mod_p(s: torch.Tensor, count: int) -> torch.Tensor:
    """[1, s, s^2, ..., s^(count-1)] mod p by doubling."""
    assert count >= 1
    out = torch.ones(1, dtype=torch.int64, device=s.device)
    s_pow = s.reshape(1)
    while out.shape[0] < count:
        out = torch.cat([out, mulmod_p(s_pow, out)])
        s_pow = mulmod_p(s_pow, s_pow)
    return out[:count]


def poly_eval_mod_p(coeffs: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Evaluate polynomial(s) at scalar s: coeffs [..., d] -> [...]."""
    pw = powers_mod_p(s, coeffs.shape[-1])
    return sum_mod_p(mulmod_p(coeffs, pw))


def gated_rowsum_plain(v: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """K7's plain version: one float64 vector-matrix product per row chunk.

    v: int64 [m, d] (entries < p); gate: 0/1 [m].  A 0/1-weighted sum of
    m < 2^21 words is < 2^53, so it is exact.
    """
    m, d = v.shape
    assert m < 1 << 21, m
    g = gate.to(torch.float64)
    total = torch.zeros(d, dtype=torch.int64, device=v.device)
    for lo in range(0, m, _CHUNK):
        part = g[lo : lo + _CHUNK] @ v[lo : lo + _CHUNK].to(torch.float64)
        total += part.to(torch.int64)
    return total % P


def gated_rowsum_mod_p(v: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """sum_{i : gate_i} v[i, :] mod p — the witness row selection.

    v: int64 [m, d] (entries < p); gate: 0/1 uint8 or bool [m].  K7: on a
    CUDA tensor, one launch of ``csrc/rowsum.cu``, which reads only the
    gated rows; v must be contiguous there (else ValueError).  On the CPU,
    ``gated_rowsum_plain``."""
    m, d = v.shape
    if v.device.type == "cpu":
        return gated_rowsum_plain(v, gate)
    if v.dtype != torch.int64 or not v.is_contiguous() or m >= 1 << 21:
        raise ValueError(f"v: expected a contiguous int64 [m < 2^21, d], got {v.dtype} "
                         f"{tuple(v.shape)} (contiguous={v.is_contiguous()})")
    if gate.shape != (m,) or gate.device != v.device:
        raise ValueError(f"gate: expected [{m}] on {v.device}, got {tuple(gate.shape)} on {gate.device}")
    gate = gate.view(torch.uint8) if gate.dtype == torch.bool else gate.to(torch.uint8)
    out = torch.empty(d, dtype=torch.int64, device=v.device)
    if m == 0 or d == 0:
        return out.zero_()
    partial = torch.empty(-(-m // ROWSUM_CHUNK_ROWS), d, dtype=torch.int64, device=v.device)
    done = torch.empty(-(-d // ROWSUM_CHUNK_ROWS), dtype=torch.int32, device=v.device)
    _build.launch("cls_gated_rowsum_p", v, gate.contiguous(), m, d, partial, done, out)
    LAUNCHES["gated_rowsum_p"] += 1
    return out


def matvec_mod_p(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_i v[..., r, i] * w[i] mod p — rows of a mod-p matvec.

    v: int64 [..., m, d]; w: int64 [d]; entries < p.  Both operands split
    into 16-bit halves; each of the four half-products sums d terms below
    2^32, so for d < 2^21 every float64 sum stays below 2^53 (exact).
    """
    d = v.shape[-1]
    assert d < 1 << 21, d
    wp = torch.stack([w & 0xFFFF, w >> 16], dim=1).to(torch.float64)  # [d, 2]
    rows = v.reshape(-1, d)
    out = []
    for lo in range(0, rows.shape[0], _CHUNK):
        vc = rows[lo : lo + _CHUNK]
        c_lo = ((vc & 0xFFFF).to(torch.float64) @ wp).to(torch.int64)  # [r, 2]
        c_hi = ((vc >> 16).to(torch.float64) @ wp).to(torch.int64)
        mid = (c_lo[:, 1] + c_hi[:, 0]) % P  # weight 2^16
        top = c_hi[:, 1] % P  # weight 2^32 = 5 (mod p)
        out.append((c_lo[:, 0] + mulmod_p(mid, 1 << 16) + mulmod_p(top, 5)) % P)
    return torch.cat(out).reshape(v.shape[:-1])
