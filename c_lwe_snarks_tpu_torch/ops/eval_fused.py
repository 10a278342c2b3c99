"""Fused keystream kernels: eval_poly's MAC (K3) and setup's encrypt (K4).

Port of ``c_lwe_snarks_tpu/ops/eval_fused.py``.  Both kernels regenerate
the ciphertext a-vectors from the CRS keystream inside the kernel, so the
keystream (11.8 GB per protocol stage at release parameters) never
reaches device memory:

* ``eval_mac_planes`` (K3, ``csrc/eval_fused.cu``): for k coefficient
  vectors over ``d`` sequential ciphertexts, the byte-plane MACs
  out[c, k, coord, digit] = sum_i byte_c(coeff_k[i]) * a_i[coord, digit];
  past 8 lanes in its many-lane form, one launch whose row segments each
  read a window of at most 20 lanes (``lane_segments``).
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

LAUNCHES = spans.count_launches({"eval_mac_planes": 0, "eval_mac_lanes": 0, "encrypt_b_fused": 0})
_PLAIN_ROWS = 32  # ciphertexts per plain-version chunk (bounds the float64 temporaries)

# K3's launch arithmetic (csrc/eval_fused.cu)
MAX_SEGMENT_ROWS = 32768  # rows a segment: its signed 32-bit sums stay exact
TARGET_BLOCKS = 4096  # blocks a sweep aims at
WIDE_LANES = 20  # the many-lane form: lanes a segment reads (kWideLanes)
WIDE_COLS = 240  # byte columns a block owns (kWideCols)
WIDE_ROWS = 256  # rows a tile (kWideRows)
MAX_SEGMENTS = 128  # segments a launch (kWideMaxSegments)


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
    ctr_ct: int, *, sections=None,
) -> torch.Tensor:
    """Plain torch form of ``eval_mac_planes`` (same output).  It holds the
    caller to ``sections``: ValueError if a coefficient outside them is
    nonzero, which the card's many-lane form would not read."""
    k, d = coeffs.shape
    if sections is not None:
        outside = torch.ones(k, d, dtype=torch.bool, device=coeffs.device)
        for r0, r1, l0, l1 in check_sections(sections, k, d):
            outside[l0:l1, r0:r1] = False
        if bool((coeffs[outside] != 0).any()):
            raise ValueError("a coefficient outside the sections is nonzero")
    cb = _coeff_planes(coeffs)
    out = torch.zeros(4 * k, n * dg.DIGITS, dtype=torch.int64, device=coeffs.device)
    for lo in range(0, d, _PLAIN_ROWS):
        rows = min(_PLAIN_ROWS, d - lo)
        a = _expand_a_plain(key, section_offset + lo * ctr_ct, rows, n)
        # each chunk's sums are < rows * 255^2: exact in float64
        out += (cb[:, lo : lo + rows] @ a.reshape(rows, -1).to(torch.float64)).to(torch.int64)
    return out.reshape(4, k, n, dg.DIGITS)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def check_sections(sections, k: int, d: int) -> tuple:
    """The sections as a tuple of (row_begin, row_end, lane_begin, lane_end);
    ValueError unless each lies inside the k lanes and d rows and no two
    share a row and a lane."""
    out = tuple(tuple(int(x) for x in sec) for sec in sections)
    for i, (r0, r1, l0, l1) in enumerate(out):
        if not (0 <= r0 <= r1 <= d and 0 <= l0 <= l1 <= k):
            raise ValueError(f"section {out[i]} lies outside {k} lanes x {d} rows")
        for q0, q1, m0, m1 in out[:i]:
            if max(r0, q0) < min(r1, q1) and max(l0, m0) < min(l1, m1):
                raise ValueError(f"sections {out[i]} and {(q0, q1, m0, m1)} overlap")
    return out


def lane_segments(d: int, n: int, sections) -> list[tuple[int, int, int, int]]:
    """The many-lane form's segments, (row_begin, row_end, lane0, lanes):
    each section's lanes in windows of at most ``WIDE_LANES``, each window's
    rows in segments of whole tiles (the last may be short) of at most
    ``MAX_SEGMENT_ROWS``, so that the launch has about ``TARGET_BLOCKS``
    blocks of ``WIDE_COLS`` byte columns.  A row and lane inside a section
    lies in exactly one segment; none outside every section does."""
    windows = [(r0, r1, a, min(WIDE_LANES, l1 - a))
               for r0, r1, l0, l1 in sections if r1 > r0 for a in range(l0, l1, WIDE_LANES)]
    if not windows:
        return []
    swept = sum(r1 - r0 for r0, r1, _, _ in windows)
    per = _ceil(TARGET_BLOCKS, _ceil(92 * n, WIDE_COLS))  # segments the sweep aims at
    seg = min(MAX_SEGMENT_ROWS, _ceil(_ceil(swept, per), WIDE_ROWS) * WIDE_ROWS)
    out = []
    for r0, r1, a, w in windows:
        step = _ceil(_ceil(r1 - r0, _ceil(r1 - r0, seg)), WIDE_ROWS) * WIDE_ROWS  # <= seg
        out += [(lo, min(r1, lo + step), a, w) for lo in range(r0, r1, step)]
    return out


def eval_mac_planes(
    key: sampling.PRGKey, section_offset: int, coeffs: torch.Tensor, n: int,
    ctr_ct: int, *, sections=None,
) -> torch.Tensor:
    """a-part MAC planes of k fused homomorphic evaluations (K3).

    coeffs: int64 [k, d] words.  Returns int64 [4, k, n, 88] with plane c
    holding sum_i byte_c(coeff_k[i]) * a_i[coord, digit] (exact).  The
    b-row MAC and the carry fold stay with the caller (models/lwe.py).

    sections: (row_begin, row_end, lane_begin, lane_end) tuples, no two
    sharing a row and a lane, outside which the caller's coefficients are
    zero; needed past 8 lanes, optional up to 8 (one section of every row
    and lane).  Up to 8 lanes the card sweeps every lane over every row in
    one launch; past 8, the many-lane form reads each section's rows with
    its lanes alone, at most ``WIDE_LANES`` lanes a segment
    (``lane_segments``), so lanes that share a window share one keystream
    pass: one launch for every ``MAX_SEGMENTS`` segments, d < 2^31.  The
    card does not check the coefficients outside the sections (that would
    take a host sync); the CPU, which runs the plain version, refuses them.
    """
    k, d = coeffs.shape
    assert ctr_ct == 92 * n and section_offset >= 0
    if sections is not None:
        sections = check_sections(sections, k, d)
    elif k > 8:
        raise ValueError(f"{k} lanes: past 8 the caller gives the sections")
    if coeffs.device.type == "cpu":
        return eval_mac_planes_plain(key, section_offset, coeffs, n, ctr_ct, sections=sections)
    if coeffs.device.type != "cuda" or key.device != coeffs.device:
        raise ValueError(f"coeffs on {coeffs.device}, key on {key.device}")
    _build.check_tensor(coeffs, torch.int64, (k, d), coeffs.device)
    if k < 1:
        raise ValueError("the kernel takes at least one coefficient vector")
    out = torch.zeros(4, k, n, dg.DIGITS, dtype=torch.int64, device=coeffs.device)
    if not d:
        return out
    c32 = _build.bits32(coeffs)
    args = (key.aes.tables32, key.aes.rk_param, key.aes.nonce_lo, key.aes.nonce_hi,
            section_offset, c32, k, d, n)
    if k <= 8:
        _build.launch("cls_eval_mac_planes", *args, out)
        LAUNCHES["eval_mac_planes"] += 1
        return out
    if d >= 1 << 31:
        raise ValueError(f"the many-lane form takes fewer than 2^31 rows, got {d}")
    segs = lane_segments(d, n, sections)
    for lo in range(0, len(segs), MAX_SEGMENTS):
        part = segs[lo : lo + MAX_SEGMENTS]
        table = torch.tensor(part, dtype=torch.int32).numpy().tobytes()
        _build.launch("cls_eval_mac_lanes", *args, table, len(part), out)
        LAUNCHES["eval_mac_lanes"] += 1
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
