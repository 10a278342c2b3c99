"""The designated verifier's decrypts and checks: K11 and its plain versions.

The port's own module: the JAX package computes the same things as jnp
code in ``models/snark.py:verifier`` and ``test_error_ok``,
``models/lwe.py:decrypt`` and ``ops/digits.py:bigint_dot``.  On a CUDA
tensor each function here is one launch of ``csrc/verify.cu`` (K11):

* ``decrypt``: (b - <a, sk>) mod p of k ciphertexts, each side taken mod
  p directly (never mod 2^704 first), the dot truncated mod 2^704;
* ``verify``: the proof's five decrypts, t(s) and v_0(s), the relations
  eq_pke1, eq_pke2, eq_div, eq_lin and the test-error bound, the verdict a
  device bool beside the seven words and the limb count; nothing is read
  back to the host.

The CPU takes the plain versions, ``decrypt_plain``, ``error_count_plain``
and ``verify_plain``: the JAX package's glue in torch (the byte products
as a float64 GEMM, anti-diagonal sums, the carry fold, ``mod_p``), which
no CUDA call falls back to.  ``LAUNCHES["verify"]`` counts both forms.
"""

from __future__ import annotations

import functools

import torch

from . import _build, modp
from . import digits as dg

LAUNCHES = {"verify": 0}
DIGITS = dg.DIGITS
SLICE_ROWS = 32  # rows of sk a decrypt block takes (csrc/verify.cu: kSliceRows)
AT_S_COLS = 2048  # columns of t and v_0 an at-s block takes (kAtSCols)
THRESHOLDS = 11  # the test-error bound's thresholds p * 2^(64j), j < 11


@functools.cache
def _thresholds(device) -> torch.Tensor:
    """p * 2^(64j) for j < 11 as uint8 digit rows [11, 88] (all < 2^704),
    on the device once."""
    return torch.tensor(dg.ints_to_digit_matrix([modp.P << (64 * j) for j in range(THRESHOLDS)]),
                        device=device)


def _dot_digits_plain(a: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """<a, sk> mod 2^704 as digits, in torch ops alone (``bigint_dot`` with
    its carry fold's plain version)."""
    return dg.carry_fold_plain(dg.bigint_dot_acc(a, sk))


def decrypt_plain(ct: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """K11's decrypt form, plain: (b - <a, sk>) mod p as int64 [...], each
    side mod p directly (DEVIATIONS §3).  ct: uint8 [..., n+1, 88]."""
    dot = _dot_digits_plain(ct[..., :-1, :], sk)
    return dg.sub_mod_p(dg.mod_p(ct[..., -1, :]), dg.mod_p(dot))


def error_count_plain(b_w: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """The test-error bound's limb count, plain: how many of p * 2^(64j),
    j < 11, are <= <a, sk> mod 2^704 (``digits_ge``: equal counts as >=);
    int64 scalar.  b_w: uint8 [n+1, 88]."""
    dot = _dot_digits_plain(b_w[:-1], sk)
    return dg.digits_ge(dot[None, :], _thresholds(dot.device)).to(torch.int64).sum()


def verify_plain(cts, sk, t, v0, s, alpha, beta, limb_bound: int):
    """K11's verifier form, plain: (ok, words) as ``verify`` returns them."""
    dec = decrypt_plain(torch.stack(list(cts)), sk)
    h_s, hath_s, hatv_s, w_s, b_s = dec.unbind()
    t_s, v0_s = modp.poly_eval_plain(torch.stack([t, v0]), s).unbind()
    count = error_count_plain(cts[4], sk)
    v_s = modp.addmod_p(v0_s, w_s)
    eq_pke1 = modp.mulmod_p(h_s, alpha) == hath_s
    eq_pke2 = modp.mulmod_p(v_s, alpha) == hatv_s
    lhs = modp.submod_p(modp.submod_p(modp.mulmod_p(v_s, v_s), 1), modp.mulmod_p(h_s, t_s))
    eq_lin = modp.mulmod_p(w_s, beta) == b_s
    ok = eq_pke1 & eq_pke2 & (lhs == 0) & eq_lin & (-count < limb_bound)
    return ok, torch.stack([h_s, hath_s, hatv_s, w_s, b_s, t_s, v0_s, count])


def _check(name: str, x: torch.Tensor, dtype, shape, device, word: bool = False) -> None:
    """Raise unless x is contiguous of this dtype, shape and device, and,
    with word, starts on a 4-byte word (the kernel stages digit rows a word
    a load)."""
    try:
        _build.check_tensor(x, dtype, shape, device)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if word and x.data_ptr() % 4:
        raise ValueError(f"{name}: expected a start aligned to 4 bytes")


def _scalar32(name: str, x: torch.Tensor, device) -> torch.Tensor:
    """The VRS's uint32 scalar as the kernel reads it: [1] on the device."""
    if x.numel() != 1 or x.device != device or x.dtype != torch.uint32:
        raise ValueError(f"{name}: expected one uint32 entry on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x.reshape(1)


def decrypt(ct: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
    """(b - <a, sk>) mod p of ciphertexts ct uint8 [..., n+1, 88] under sk
    uint8 [n, 88]: int64 [...].

    K11's decrypt form: on a CUDA tensor one launch over every ciphertext
    (ct made contiguous; it and sk must start on a 4-byte word, sk must be
    contiguous, else ValueError); on the CPU, ``decrypt_plain``."""
    if ct.device.type == "cpu":
        return decrypt_plain(ct, sk)
    n = sk.shape[0]
    if ct.shape[-2:] != (n + 1, DIGITS) or ct.dtype != torch.uint8:
        raise ValueError(f"ct: expected uint8 [..., {n + 1}, {DIGITS}], got {ct.dtype} "
                         f"{tuple(ct.shape)}")
    _check("sk", sk, torch.uint8, (n, DIGITS), ct.device, word=True)
    if n == 0:
        raise ValueError("decrypt: expected n > 0")
    lead = ct.shape[:-2]
    flat = ct.contiguous().reshape(-1, n + 1, DIGITS)
    k = flat.shape[0]
    _check("ct", flat, torch.uint8, (k, n + 1, DIGITS), ct.device, word=True)
    out = torch.empty(k, dtype=torch.int64, device=ct.device)
    if k:
        n_part = k * -(-n // SLICE_ROWS) * DIGITS
        ws = torch.empty(n_part + k, dtype=torch.int32, device=ct.device)
        _build.launch("cls_decrypt", flat, k, sk, n, ws[:n_part], ws[n_part:], out)
        LAUNCHES["verify"] += 1
    return out.reshape(lead)


def verify(cts, sk, t, v0, s, alpha, beta, limb_bound: int):
    """The designated verifier's checks on a proof: (ok, words).

    cts: the five ciphertexts (h, hat_h, hat_v, v_w, b_w), each uint8 [n+1,
    88]; sk uint8 [n, 88]; t, v0 uint32 [d] (the SSP's, as it holds them);
    s, alpha, beta the VRS's one-entry uint32 tensors < p (any other type
    of t, v0 or a scalar is a ValueError on every device); limb_bound:
    log_smudging // 8.  Returns ok, a bool scalar (eq_pke1, eq_pke2,
    eq_div, eq_lin and -count < limb_bound), and words, int64 [8]:
    the five decrypts, t(s), v_0(s) and count, the number of p * 2^(64j),
    j < 11, that are <= b_w's dot mod 2^704.

    K11's verifier form: on a CUDA tensor one launch that reads the five
    ciphertexts where they lie (each made contiguous; they and sk must
    start on a 4-byte word, else ValueError) and the scalars on the device,
    with no host sync; on the CPU, ``verify_plain``."""
    dev = cts[0].device
    n, d = sk.shape[0], t.shape[-1]
    _check("t", t, torch.uint32, (d,), dev)
    _check("v0", v0, torch.uint32, (d,), dev)
    scalars = [_scalar32(name, x, dev) for name, x in (("s", s), ("alpha", alpha), ("beta", beta))]
    if dev.type == "cpu":
        return verify_plain(cts, sk, t, v0, s, alpha, beta, limb_bound)
    rows = [c.contiguous() for c in cts]
    if len(rows) != 5:
        raise ValueError(f"cts: expected the proof's five ciphertexts, got {len(rows)}")
    for name, c in zip(("h", "hat_h", "hat_v", "v_w", "b_w"), rows):
        _check(name, c, torch.uint8, (n + 1, DIGITS), dev, word=True)
    _check("sk", sk, torch.uint8, (n, DIGITS), dev, word=True)
    if n == 0 or d == 0:
        raise ValueError(f"verify: expected n, d > 0, got n={n}, d={d}")
    slices, segs = -(-n // SLICE_ROWS), -(-d // AT_S_COLS)
    n_part = 5 * slices * DIGITS
    ws = torch.empty(n_part + 2 * segs + 6, dtype=torch.int32, device=dev)
    words = torch.empty(8, dtype=torch.int64, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    _build.launch("cls_verify", *rows, sk, n, t, v0, d, *scalars, limb_bound,
                  ws[:n_part], ws[n_part : n_part + 2 * segs], ws[n_part + 2 * segs :],
                  words, ok)
    LAUNCHES["verify"] += 1
    return ok, words
