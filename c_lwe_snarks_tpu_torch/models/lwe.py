"""Regev-LWE over digit tensors: encrypt, decrypt, ciphertext algebra, eval.

Port of ``c_lwe_snarks_tpu/models/lwe.py``.  A ciphertext batch is one
uint8 tensor ``[..., n+1, 88]``: coordinate n is the b-component, and the
88 little-endian base-256 digits are the effective mod-2^704 ring.  The
a-vectors of CRS ciphertexts are never stored: ``encrypt_section`` (K4)
and ``eval_poly_multi`` (K3) regenerate them from the AES-CTR stream
inside their kernels.  Both also have a two-stage ``"scan"`` form, a
Python loop over tiles that expands each tile's a-slab with the raw
keystream kernel (K1) and contracts it in torch; it gives the same bytes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import digits as dg
from ..ops import eval_fused, sampling
from ..utils.params import Params

DIGITS = dg.DIGITS


def u32_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """int64 words [...] -> uint8 [..., 4] little-endian."""
    shifts = torch.arange(4, device=x.device) * 8
    return ((x[..., None] >> shifts) & 255).to(torch.uint8)


def u32_to_digits(x: torch.Tensor, ndigits: int = DIGITS) -> torch.Tensor:
    """int64 words [...] -> zero-extended digit rows [..., ndigits]."""
    return F.pad(u32_to_bytes(x), (0, ndigits - 4))


def pad_digits(rows: torch.Tensor, ndigits: int = DIGITS) -> torch.Tensor:
    """Zero-extend byte rows [..., k] to [..., ndigits]."""
    k = rows.shape[-1]
    return rows if k == ndigits else F.pad(rows, (0, ndigits - k))


def key_gen(key: sampling.PRGKey, byte_offset: int, params: Params) -> torch.Tensor:
    """sk as uint8 [n, 88]: n sequential 92-byte draws (top 4 bytes dropped)."""
    return sampling.sample_digit_rows(
        key, byte_offset, params.n, draw_bytes=params.logq_bytes)


def ct_a(ct: torch.Tensor) -> torch.Tensor:
    return ct[..., :-1, :]


def ct_b(ct: torch.Tensor) -> torch.Tensor:
    return ct[..., -1, :]


def ct_export(ct: torch.Tensor, params: Params) -> torch.Tensor:
    """Compressed form: b as 92 LE bytes, top 4 zero."""
    return b_export(ct_b(ct), params)


def b_export(b: torch.Tensor, params: Params) -> torch.Tensor:
    """Pad b digit rows [..., 88] to the 92-byte stored format."""
    return pad_digits(b, params.ct_bytes)


def ct_import(
    key: sampling.PRGKey, byte_offset: int, b92: torch.Tensor, params: Params
) -> torch.Tensor:
    """Re-expand a from the stream and attach b: [count, n+1, 88]."""
    a = sampling.expand_a(key, byte_offset, b92.shape[0], params.n)
    return torch.cat([a, b92[:, None, :DIGITS]], dim=1)


def _b_rows(dot: torch.Tensor, msgs: torch.Tensor, errs: torch.Tensor, params: Params):
    """dot + p * e + m mod 2^704 as digit rows, dot given as int64 planes."""
    return dg.carry_fold(dot + dg.pe_m_planes(msgs, errs))


def encrypt_b(
    a: torch.Tensor, sk: torch.Tensor, msgs: torch.Tensor, errs: torch.Tensor, params: Params
) -> torch.Tensor:
    """b-components for a batch: <sk, a> + p * e + m mod 2^704.

    a: uint8 [B, n, 88]; sk: uint8 [n, 88]; msgs: int64 words [B]; errs:
    uint8 [B, 88] (the 69-byte uniform error, zero-extended).  Returns
    uint8 [B, 88].
    """
    return _b_rows(dg.partial_fold(dg.bigint_dot_acc(a, sk)), msgs, errs, params)


def encrypt(
    key: sampling.PRGKey,
    byte_offset: int,
    sk: torch.Tensor,
    msgs: torch.Tensor,
    errs: torch.Tensor,
    params: Params,
) -> torch.Tensor:
    """Full ciphertexts [B, n+1, 88] with a expanded from the CRS stream."""
    a = sampling.expand_a(key, byte_offset, msgs.shape[0], params.n)
    b = encrypt_b(a, sk, msgs, errs, params)
    return torch.cat([a, b[:, None, :]], dim=1)


def encrypt_section(
    key: sampling.PRGKey,
    section_offset: int,
    sk: torch.Tensor,
    msgs: torch.Tensor,
    errs: torch.Tensor,
    params: Params,
    *,
    tile: int | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Compressed b-rows [B, 88] of B sequential encryptions from the offset.

    b = <sk, a_i> + p * e_i + m_i mod 2^704.  msgs: int64 words [B]; errs:
    uint8 [B, 88].  ``impl``: "fused" takes <sk, a_i> from the fused
    keystream->encrypt kernel (K4); "scan" expands the a-slab of one
    ``tile`` of ciphertexts at a time (K1) and contracts it in torch;
    "auto" is "fused" up to n = 6,379, where K4's signed 32-bit sums
    hold (``eval_fused.fits_enc_bound``), and "scan" past it.  K4 takes
    any offset and any count up to n = 6,379, so no other eligibility
    rule of the JAX package carries over.
    """
    total = msgs.shape[0]
    if impl not in ("auto", "fused", "scan"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "auto":
        impl = "fused" if eval_fused.fits_enc_bound(params.n) else "scan"
    if impl == "fused":
        # K4's nibble planes straight into K10's b-row form
        v_lo, v_hi = eval_fused.encrypt_b_planes(
            key, section_offset, sk, total, params.n, params.ctr_ct)
        return dg.carry_fold_b_rows(v_lo, v_hi, errs, msgs)
    if tile is None:
        tile = min(total, 256)
    if total <= 2 or tile % 2:
        a = sampling.expand_a(key, section_offset, total, params.n)
        return encrypt_b(a, sk, msgs, errs, params)
    if total % tile:
        # pad with dummy encryptions to whole tiles (their keystream lies
        # past the section, which no real term reads) and drop them
        extra = -total % tile
        out = encrypt_section(
            key, section_offset, sk, F.pad(msgs, (0, extra)), F.pad(errs, (0, 0, 0, extra)),
            params, tile=tile, impl="scan")
        return out[:total]
    rows = []
    for lo in range(0, total, tile):
        a = sampling.expand_a(key, section_offset + lo * params.ctr_ct, tile, params.n)
        rows.append(encrypt_b(a, sk, msgs[lo : lo + tile], errs[lo : lo + tile], params))
    return torch.cat(rows)


def decrypt(ct: torch.Tensor, sk: torch.Tensor, params: Params) -> torch.Tensor:
    """(b - <a, sk>) mod p, taken mod p directly (not mod 2^704 first)."""
    dot = dg.bigint_dot(ct_a(ct), sk)
    return dg.sub_mod_p(dg.mod_p(ct_b(ct)), dg.mod_p(dot))


def ct_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return dg.add_digits(x, y)


def ct_mul_ui(ct: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """ct * c for a 32-bit scalar word c."""
    return dg.scalar_mul_digits(ct, u32_to_bytes(c))


def ct_select_add(pred: torch.Tensor, acc: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """acc + ct where pred else acc (witness-bit accumulation)."""
    return dg.select_digits(
        torch.broadcast_to(pred, acc.shape[:-1]), dg.add_digits(acc, ct), acc)


def smudge(
    ct: torch.Tensor, s_digits: torch.Tensor, sign_positive: torch.Tensor, params: Params
) -> torch.Tensor:
    """b += ±(uniform log_smudging bits) * p; only the b coordinate changes.

    On a CUDA tensor one launch of K10's smudge form on a copy of ct
    (``digits.smudge_rows``); on the CPU its plain version."""
    return dg.smudge_rows(ct, s_digits, sign_positive)


def eval_poly_multi_acc(
    key: sampling.PRGKey,
    section_offset: int,
    b_rows: torch.Tensor,
    coeffs: torch.Tensor,
    params: Params,
    *,
    tile: int | None = None,
) -> torch.Tensor:
    """Partial accumulator of k homomorphic evaluations: int64 [k, n+1, 88].

    The scan form: a Python loop over tiles of ``tile`` terms; each step
    expands the tile's a-slab from the stream (K1), MACs the 4k coefficient
    byte planes against the [tile, (n+1) * 88] ciphertext rows in one exact
    matmul and folds once, so positions stay <= 255 + 2^23 (one
    ``partial_fold`` short of normalized digits), as in the JAX package.
    ``d`` must be a multiple of ``tile``.
    """
    k, d = coeffs.shape
    n = params.n
    if tile is None:
        tile = min(d, 256)
    assert d % tile == 0, (d, tile)
    cb = u32_to_bytes(coeffs).permute(1, 0, 2).reshape(d, k * 4)  # [d, (k, byte)]
    acc = torch.zeros(k, n + 1, DIGITS, dtype=torch.int64, device=coeffs.device)
    for lo in range(0, d, tile):
        a = sampling.expand_a(key, section_offset + lo * params.ctr_ct, tile, n)
        x = torch.cat([a, b_rows[lo : lo + tile, None, :DIGITS]], dim=1)
        planes = dg.coeff_mac_acc(cb[lo : lo + tile], x.reshape(tile, -1))  # [k*4, X]
        comb = dg.combine_shift_planes(
            planes.reshape(k, 4, n + 1, DIGITS).permute(1, 0, 2, 3))  # < 2^26
        acc = dg.partial_fold(acc + comb)
    return acc


def eval_poly_multi(
    key: sampling.PRGKey,
    section_offset: int,
    b_rows: torch.Tensor,
    coeffs: torch.Tensor,
    params: Params,
    *,
    tile: int | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """k homomorphic polynomial evaluations sharing one keystream pass.

    b_rows: uint8 [d, 88 or 92] (compressed b-components of the section's
    ciphertexts); coeffs: int64 words [k, d].  Returns uint8 [k, n+1, 88]:
    sum_i coeff_k[i] * ct_i mod 2^704.

    ``impl``: "fused" runs the a-part MAC in the fused keystream->MAC
    kernel (K3) and the b-row MAC as one small exact matmul, and folds
    both in K10's MAC-plane form (``digits.fold_mac_planes``); "scan" runs
    the two-stage loop of ``eval_poly_multi_acc`` over tiles of ``tile``
    terms, zero-padding the degree to whole tiles (padded terms multiply
    keystream past the section by zero); "auto" is "fused": K3 takes any
    byte offset, any row count and any degree (it sums signed 32-bit row segments
    into int64), so none of the JAX package's eligibility rules carry over.
    """
    if impl not in ("auto", "fused", "scan"):
        raise ValueError(f"unknown impl {impl!r}")
    k, d = coeffs.shape
    if impl == "scan":
        tile_eff = tile if tile is not None else min(d + (d & 1), 256)
        extra = -d % tile_eff
        if extra:
            coeffs = F.pad(coeffs, (0, extra))
            b_rows = F.pad(b_rows[:, :DIGITS], (0, 0, 0, extra))
        return dg.carry_fold(
            eval_poly_multi_acc(key, section_offset, b_rows, coeffs, params, tile=tile_eff))
    acc_a = eval_fused.eval_mac_planes(
        key, section_offset, coeffs, params.n, params.ctr_ct)  # [4, k, n, 88]
    cb = u32_to_bytes(coeffs)  # [k, d, 4]
    acc_b = dg.u8_matmul(
        cb.permute(2, 0, 1).reshape(4 * k, d), b_rows[:, :DIGITS]).reshape(4, k, DIGITS)
    return dg.fold_mac_planes(acc_a, acc_b)  # one K10 launch on the card


def eval_poly(
    key: sampling.PRGKey,
    section_offset: int,
    b_rows: torch.Tensor,
    coeffs: torch.Tensor,
    params: Params,
    *,
    tile: int | None = None,
) -> torch.Tensor:
    """Single-polynomial wrapper: returns uint8 [n+1, 88]."""
    return eval_poly_multi(key, section_offset, b_rows, coeffs[None], params, tile=tile)[0]
