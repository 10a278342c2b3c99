"""Z_p arithmetic for p = 2^32 - 5 on int64 tensors.

Port of ``c_lwe_snarks_tpu/ops/modp.py``.  torch has no uint32 shifts,
adds or compares on the CPU, so the arithmetic here runs on int64 tensors
holding values in [0, 2^32).  Every function takes the JAX package's
uint32 words as well (the SSP's coefficients, the VRS's scalars): ``words``
widens them to int64 once, at entry, and the result is int64 on every
device.  Every product below is split so that no intermediate reaches
2^63, and every result is the canonical residue in [0, p) — the same
value the JAX package computes with its uint32 tricks (including
``add_u32_mod_p``'s double-wrap window, which exact int64 arithmetic
covers by construction).  The SSP's coefficient matrices are read as
they are: ``gated_rowsum_mod_p``, ``matvec_mod_p`` and
``poly_eval_mod_p`` take uint32 rows, as the JAX package holds them, on
every device (any other type raises ValueError), and return int64 words.

On a CUDA tensor these functions run hand-written kernels, and
``LAUNCHES`` counts their launches: the gated row-sum is K7
(``csrc/rowsum.cu``); ``matvec_mod_p`` and ``poly_eval_mod_p`` are K8, the
latter in its at-s form (the powers of s made in the kernel); and
``powers_mod_p`` and ``message_powers`` are K9 (``csrc/modp.cu``).  Their
plain versions, which the CPU takes, are ``gated_rowsum_plain`` and
``matvec_plain`` (float64 matrix products: torch refuses integer ``mm`` on
CUDA, and a float64 sum of integers is exact while every partial sum stays
below 2^53, which the operand splits here guarantee), ``poly_eval_plain``,
``powers_plain`` (doubling) and ``message_powers_plain``.
"""

from __future__ import annotations

import torch

from ..utils import spans
from . import _build

P = (1 << 32) - 5  # plaintext modulus (GAMMA_P)

# rows per chunk in the contractions: bounds each widened temporary at
# CHUNK x d x 8 bytes (256 MiB at d = 2^15)
_CHUNK = 1024
# rows a CUDA block of K7 sums (csrc/rowsum.cu: kChunkRows, also its columns)
ROWSUM_CHUNK_ROWS = 256
# K8 (csrc/modp.cu): rows a CUDA block sums together (kRows), the fewest
# columns a block takes when a row is split over blocks, and the blocks
# that fill the card (132 SMs x 8)
MATVEC_ROWS = 4
MATVEC_MIN_SEGMENT = 2048
MATVEC_FILL_BLOCKS = 1056
# K8's per-thread sums are exact while d < 2^37: a row of 2^37 uint32
# entries is 512 GiB, more than any card holds
MATVEC_MAX_D = 1 << 37
# columns a float64 chunk of matvec_plain sums: each half-product sum stays
# below 2^53 for fewer than 2^21 columns
_MATVEC_PLAIN_COLS = 1 << 20

LAUNCHES = spans.count_launches({"gated_rowsum_p": 0, "matvec_mod_p": 0, "powers_mod_p": 0})


def words(x):
    """The seam where the JAX package's uint32 words enter the int64
    arithmetic: a uint32 tensor widened to int64 (one copy); any other
    tensor, and a Python int, as it is."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.uint32:
        return x.to(torch.int64)
    return x


def mul32(a, b):
    """Exact 32x32 -> 64-bit product of words in [0, 2^32) as (hi, lo) words."""
    a, b = words(a), words(b)
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1  # each < 2^32
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)  # < 3 * 2^16
    lo = (ll & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def mulmod_p(a, b):
    """(a * b) mod p for words a, b in [0, 2^32) (tensors or ints)."""
    a, b = words(a), words(b)
    # a * (b >> 16) < 2^48 and a * (b & 0xFFFF) < 2^48: no int64 overflow
    return ((a * (b >> 16)) % P * 65536 + a * (b & 0xFFFF)) % P


def addmod_p(a, b):
    """(a + b) mod p for words in [0, 2^32)."""
    return (words(a) + words(b)) % P


def add_u32_mod_p(a, b):
    """(a + b) mod p for two arbitrary words (exact, no double wrap)."""
    return (words(a) + words(b)) % P


def submod_p(a, b):
    """(a - b) mod p (torch's ``%`` takes the sign of the divisor)."""
    return (words(a) - words(b)) % P


def fold64_mod_p(hi, lo):
    """(hi * 2^32 + lo) mod p, using 2^32 = 5 (mod p)."""
    return (words(hi) * 5 + words(lo)) % P


def bytes_to_u64_mod_p(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 8] little-endian words -> value mod p (rand_modp)."""
    w = b.to(torch.int64)
    shifts = torch.arange(4, device=b.device) * 8
    lo = (w[..., :4] << shifts).sum(-1)
    hi = (w[..., 4:] << shifts).sum(-1)
    return fold64_mod_p(hi, lo)


def powmod_p(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e mod p, static exponent (square and multiply)."""
    base = words(a)
    result = torch.ones_like(base)
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


def powers_plain(s: torch.Tensor, count: int) -> torch.Tensor:
    """K9's plain version: [1, s, ..., s^(count-1)] mod p by doubling."""
    assert count >= 1
    out = torch.ones(1, dtype=torch.int64, device=s.device)
    s_pow = s.reshape(1)
    while out.shape[0] < count:
        out = torch.cat([out, mulmod_p(s_pow, out)])
        s_pow = mulmod_p(s_pow, s_pow)
    return out[:count]


def _check_scalar(name: str, x: torch.Tensor, device) -> None:
    if x.dtype != torch.int64 or x.numel() != 1 or x.device != device:
        raise ValueError(f"{name}: expected one int64 entry on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def powers_mod_p(s: torch.Tensor, count: int) -> torch.Tensor:
    """[1, s, s^2, ..., s^(count-1)] mod p: int64 [count].

    s: a one-element int64 or uint32 tensor (0-d or [1]) < p; a uint32 s is
    widened first (``words``).  K9: on a CUDA tensor, one launch of
    ``csrc/modp.cu`` that reads s on the device (the host never does); on
    the CPU, ``powers_plain``."""
    assert count >= 1
    s = words(s)
    if s.device.type == "cpu":
        return powers_plain(s, count)
    _check_scalar("s", s, s.device)
    out = torch.empty(count, dtype=torch.int64, device=s.device)
    _build.launch("cls_powers_mod_p", s.reshape(1), s.reshape(1), 0, count, out)
    LAUNCHES["powers_mod_p"] += 1
    return out


def message_powers_plain(s: torch.Tensor, alpha: torch.Tensor, count: int) -> torch.Tensor:
    """K9's messages form, plain: the powers, then alpha times each."""
    powers = powers_plain(s, count)
    return torch.cat([powers, mulmod_p(alpha, powers)])


def message_powers(s: torch.Tensor, alpha: torch.Tensor, count: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """[s^0, ..., s^(count-1), alpha s^0, ..., alpha s^(count-1)] mod p:
    int64 [2 count], setup's first 2d plaintexts (CTR_S, then CTR_AS).

    s, alpha: one-element int64 tensors < p (uint32 ones are widened
    first); out: where to write (a contiguous int64 [2 count], e.g. the
    head of the message buffer).  K9's messages form: on a CUDA tensor one
    launch that reads s and alpha on the device; on the CPU,
    ``message_powers_plain``."""
    assert count >= 1
    s, alpha = words(s), words(alpha)
    if s.device.type == "cpu":
        want = message_powers_plain(s, alpha, count)
        return want if out is None else out.copy_(want)
    _check_scalar("s", s, s.device)
    _check_scalar("alpha", alpha, s.device)
    if out is None:
        out = torch.empty(2 * count, dtype=torch.int64, device=s.device)
    elif out.dtype != torch.int64 or out.shape != (2 * count,) or not out.is_contiguous() \
            or out.device != s.device:
        raise ValueError(f"out: expected a contiguous int64 [{2 * count}] on {s.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    _build.launch("cls_powers_mod_p", s.reshape(1), alpha.reshape(1), 1, count, out)
    LAUNCHES["powers_mod_p"] += 1
    return out


def poly_eval_plain(coeffs: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K8's at-s form, plain: the powers of s, then the matvec."""
    return matvec_plain(coeffs, powers_plain(s, coeffs.shape[-1]))


def poly_eval_mod_p(coeffs: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Evaluate polynomial(s) at scalar s: coeffs uint32 [..., d] -> int64
    [...] mod p.

    K8's at-s form: on a CUDA tensor one launch, each polynomial a row and
    w = s^i made in the block from s read on the device (no powers
    buffer); coeffs must be contiguous there (else ValueError).  On the
    CPU, ``poly_eval_plain``.  s: int64 or uint32, one entry."""
    _check_uint32(coeffs)
    s = words(s)
    if coeffs.device.type == "cpu":
        return poly_eval_plain(coeffs, s)
    _check_scalar("s", s, coeffs.device)
    return _matvec_launch("cls_matvec_at_s_mod_p", coeffs, s.reshape(1))


def _check_uint32(v: torch.Tensor) -> None:
    """K7's and K8's rows are the SSP's uint32 coefficients on every device:
    no wrapper converts them (an int64 copy of the release v is 5.7 GB)."""
    if v.dtype != torch.uint32:
        raise ValueError(f"v: expected uint32 coefficients, got {v.dtype}")


def gated_rowsum_plain(v: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """K7's plain version: one float64 vector-matrix product per row chunk,
    each chunk widened on its own.

    v: integer [m, d] (entries < p); gate: 0/1 [m].  A 0/1-weighted sum of
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

    v: uint32 [m, d] (entries < p); gate: 0/1 uint8 or bool [m]; returns
    int64 [d].  K7: on a CUDA tensor, one launch of ``csrc/rowsum.cu``,
    which reads only the gated rows; v must be contiguous there (else
    ValueError).  On the CPU, ``gated_rowsum_plain``."""
    m, d = v.shape
    _check_uint32(v)
    if v.device.type == "cpu":
        return gated_rowsum_plain(v, gate)
    if not v.is_contiguous() or m >= 1 << 21:
        raise ValueError(f"v: expected a contiguous uint32 [m < 2^21, d], got "
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


def matvec_plain(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K8's plain version: float64 products over 16-bit halves.

    v: integer [..., m, d], widened chunk by chunk; w: int64 [d]; entries
    < p.  Both operands split into 16-bit halves; each of the four
    half-products sums fewer than 2^21 terms below 2^32 in a column chunk,
    so every float64 sum stays below 2^53 (exact); the chunks' residues
    are added mod p.
    """
    d = v.shape[-1]
    rows = v.reshape(-1, d)
    total = torch.zeros(rows.shape[0], dtype=torch.int64, device=v.device)
    for c0 in range(0, d, _MATVEC_PLAIN_COLS):
        wc = w[c0 : c0 + _MATVEC_PLAIN_COLS]
        wp = torch.stack([wc & 0xFFFF, wc >> 16], dim=1).to(torch.float64)  # [cols, 2]
        for lo in range(0, rows.shape[0], _CHUNK):
            vc = rows[lo : lo + _CHUNK, c0 : c0 + _MATVEC_PLAIN_COLS].to(torch.int64)
            c_lo = ((vc & 0xFFFF).to(torch.float64) @ wp).to(torch.int64)  # [r, 2]
            c_hi = ((vc >> 16).to(torch.float64) @ wp).to(torch.int64)
            mid = (c_lo[:, 1] + c_hi[:, 0]) % P  # weight 2^16
            top = c_hi[:, 1] % P  # weight 2^32 = 5 (mod p)
            part = (c_lo[:, 0] + mulmod_p(mid, 1 << 16) + mulmod_p(top, 5)) % P
            total[lo : lo + _CHUNK] = (total[lo : lo + _CHUNK] + part) % P
    return total.reshape(v.shape[:-1])


def matvec_splits(rows: int, d: int) -> int:
    """Blocks K8 splits each row's columns over: 1 when the row groups
    alone fill the card, else enough to fill it, each block taking at
    least MATVEC_MIN_SEGMENT columns (at most 65,535: the grid's y)."""
    groups = -(-rows // MATVEC_ROWS)
    if groups >= MATVEC_FILL_BLOCKS:
        return 1
    return max(1, min(-(-MATVEC_FILL_BLOCKS // groups), -(-d // MATVEC_MIN_SEGMENT), 65535))


def matvec_mod_p(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_i v[..., r, i] * w[i] mod p — rows of a mod-p matvec, any d.

    v: uint32 [..., m, d]; w: int64 or uint32 [d] (``words``); entries <
    p.  Returns int64 [..., m] in [0, p).  K8: on a CUDA tensor, one launch
    of ``csrc/modp.cu``, which reads v once; v and w must be contiguous
    there (else ValueError).  On the CPU, ``matvec_plain``."""
    d = v.shape[-1]
    _check_uint32(v)
    w = words(w)
    if v.device.type == "cpu":
        return matvec_plain(v, w)
    if w.dtype != torch.int64 or w.shape != (d,) or w.device != v.device or not w.is_contiguous():
        raise ValueError(f"w: expected a contiguous int64 [{d}] on {v.device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    return _matvec_launch("cls_matvec_mod_p", v, w)


def _matvec_launch(name: str, v: torch.Tensor, operand: torch.Tensor) -> torch.Tensor:
    """One K8 launch over the rows of v (w or s as the operand)."""
    d = v.shape[-1]
    if not v.is_contiguous() or d >= MATVEC_MAX_D:
        raise ValueError(f"v: expected a contiguous uint32 [..., m, d < 2^37], got "
                         f"{tuple(v.shape)} (contiguous={v.is_contiguous()})")
    rows = v.numel() // d if d else 0
    if rows == 0 or d == 0:
        return torch.zeros(v.shape[:-1], dtype=torch.int64, device=v.device)
    out = torch.empty(v.shape[:-1], dtype=torch.int64, device=v.device)
    splits = matvec_splits(rows, d)
    groups = -(-rows // MATVEC_ROWS)
    partial = torch.empty(rows * splits if splits > 1 else 0, dtype=torch.int64, device=v.device)
    done = torch.empty(groups if splits > 1 else 0, dtype=torch.int32, device=v.device)
    _build.launch(name, v, operand, rows, d, splits, partial, done, out)
    LAUNCHES["matvec_mod_p"] += 1
    return out
