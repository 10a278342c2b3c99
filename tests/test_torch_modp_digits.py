"""PyTorch port vs the JAX package: Z_p arithmetic and mod-2^704 digits.

The same numpy inputs (seeded) go through both packages; every result
must be equal, tolerance 0 (residues mod p and uint8 digits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.ops import digits as jd
from c_lwe_snarks_tpu.ops import modp as jm
from c_lwe_snarks_tpu_torch.ops import digits as td
from c_lwe_snarks_tpu_torch.ops import modp as tm

torch.set_num_threads(1)

P = (1 << 32) - 5
U32 = np.uint32


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _rows(x) -> torch.Tensor:
    """Coefficient rows as the SSP holds them: uint32, as in the JAX package."""
    return torch.from_numpy(np.asarray(x).astype(U32))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


def _words(rng, shape, hi=1 << 32):
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(U32)


def _window_pairs(rng, k):
    """Word pairs with a + b in the double-wrap window [2^33 - 5, 2^33 - 2]."""
    s = rng.integers((1 << 33) - 5, (1 << 33) - 1, size=k)
    a = rng.integers(s - ((1 << 32) - 1), 1 << 32)
    return a.astype(U32), (s - a).astype(U32)


@pytest.mark.parametrize("op", ["mulmod_p", "addmod_p", "add_u32_mod_p", "submod_p", "fold64_mod_p"])
def test_binary_modp_ops(op):
    rng = np.random.default_rng(1)
    a, b = _words(rng, 4000), _words(rng, 4000)
    if op == "addmod_p":  # JAX's domain: at least one operand < p
        a = a % U32(P)
    if op == "submod_p":  # JAX's domain: both < p
        a, b = a % U32(P), b % U32(P)
    if op in ("add_u32_mod_p", "fold64_mod_p"):  # incl. the double-wrap window
        wa, wb = _window_pairs(rng, 500)
        a, b = np.concatenate([a, wa]), np.concatenate([b, wb])
    edge = np.array([0, 1, P - 1, P, (1 << 32) - 1], U32)
    a, b = np.concatenate([a, edge, edge[::-1]]), np.concatenate([b, edge, edge])
    if op == "addmod_p":
        a = a % U32(P)
    if op == "submod_p":
        a, b = a % U32(P), b % U32(P)
    want = jax.jit(getattr(jm, op))(jnp.asarray(a), jnp.asarray(b))
    _eq(getattr(tm, op)(_t(a), _t(b)), want)


def test_bytes_to_u64_mod_p():
    rng = np.random.default_rng(2)
    b = rng.integers(0, 256, size=(300, 8), dtype=np.uint8)
    b[0] = 255
    b[1] = [0xFB, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF]
    want = jax.jit(jm.bytes_to_u64_mod_p)(jnp.asarray(b))
    _eq(tm.bytes_to_u64_mod_p(torch.from_numpy(b)), want)


def test_sum_powers_poly_eval():
    rng = np.random.default_rng(3)
    x = _words(rng, (3, 1000), P)
    s = U32(rng.integers(0, P))
    _eq(tm.sum_mod_p(_t(x)), jax.jit(jm.sum_mod_p)(jnp.asarray(x)))
    for count in (1, 7, 64, 1000):
        want = jax.jit(jm.powers_mod_p, static_argnums=1)(jnp.uint32(s), count)
        _eq(tm.powers_mod_p(_t(s), count), want)
    want = jax.jit(jm.poly_eval_mod_p)(jnp.asarray(x), jnp.uint32(s))
    _eq(tm.poly_eval_mod_p(_rows(x), _t(s)), want)


def test_gated_rowsum_and_matvec():
    """Byte-plane contractions, incl. all-(p-1) rows (the K * 255^2 bound)."""
    rng = np.random.default_rng(4)
    m, d = 37, 2048
    v = _words(rng, (m, d), P)
    v[0] = P - 1
    gate = rng.integers(0, 2, size=m, dtype=np.uint8)
    gate[0] = 1
    w = _words(rng, d, P)
    w[:7] = P - 1
    want = jax.jit(jm.gated_rowsum_mod_p)(jnp.asarray(v), jnp.asarray(gate))
    _eq(tm.gated_rowsum_mod_p(_rows(v), torch.from_numpy(gate)), want)
    want = jax.jit(jm.matvec_mod_p)(jnp.asarray(v), jnp.asarray(w))
    _eq(tm.matvec_mod_p(_rows(v), _t(w)), want)


def test_invmod_p():
    rng = np.random.default_rng(5)
    a = _words(rng, 20, P - 1) + U32(1)
    _eq(tm.invmod_p(_t(a)), jax.jit(jm.invmod_p)(jnp.asarray(a)))


# --------------------------------------------------------------------------
# digits
# --------------------------------------------------------------------------


def _digits(rng, shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _u8(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.uint8))


def test_partial_fold():
    rng = np.random.default_rng(6)
    acc = rng.integers(0, 1 << 31, size=(5, 88), dtype=np.int64).astype(np.int32)
    _eq(td.partial_fold(_t(acc)), jax.jit(jd.partial_fold)(jnp.asarray(acc)))


@pytest.mark.parametrize("case", ["random", "worst", "ripple"])
def test_carry_fold(case):
    """Random planes, the worst case (every plane 2^31 - 1) and carry
    ripples through runs of 255 digits."""
    rng = np.random.default_rng(7)
    if case == "random":
        acc = rng.integers(0, 1 << 31, size=(20, 88), dtype=np.int64)
    elif case == "worst":
        acc = np.full((3, 88), (1 << 31) - 1, np.int64)
    else:
        acc = np.full((4, 88), 255, np.int64)
        acc[0, 0] = 256
        acc[1, 10] = 256 + 255 * 256
        acc[2, 87] = 256
        acc[3, ::7] = 511
    acc = acc.astype(np.int32)
    want = jax.jit(jd.carry_fold)(jnp.asarray(acc))
    _eq(td.carry_fold(_t(acc)), want)


@pytest.mark.parametrize("k", [88, 1470, 32768])
def test_u8_matmul_bounds(k):
    """K * 255^2 sums exact up to the release K = 2^15 (all-255 operands)."""
    rng = np.random.default_rng(8)
    a = _digits(rng, (3, k))
    b = _digits(rng, (k, 5))
    a[0] = 255
    b[:, 0] = 255
    want = jax.jit(jd.u8_matmul)(jnp.asarray(a), jnp.asarray(b))
    got = td.u8_matmul(_u8(a), _u8(b))
    _eq(got, want)
    assert int(got[0, 0]) == k * 255 * 255


def test_bigint_dot_and_acc():
    rng = np.random.default_rng(9)
    n = 40
    a = _digits(rng, (3, n, 88))
    b = _digits(rng, (n, 88))
    a[0] = 255
    b[:] = np.where(np.arange(n)[:, None] % 2 == 0, 255, b)
    _eq(td.bigint_dot_acc(_u8(a), _u8(b)), jax.jit(jd.bigint_dot_acc)(jnp.asarray(a), jnp.asarray(b)))
    _eq(td.bigint_dot(_u8(a), _u8(b)), jax.jit(jd.bigint_dot)(jnp.asarray(a), jnp.asarray(b)))


def test_combine_shift_planes():
    rng = np.random.default_rng(10)
    planes = rng.integers(0, 1 << 31, size=(4, 3, 88), dtype=np.int64).astype(np.int32)
    want = jax.jit(jd.combine_shift_planes)(jnp.asarray(planes))
    _eq(td.combine_shift_planes(_t(planes)), want)


def test_elementwise_digit_ops():
    rng = np.random.default_rng(11)
    a, b = _digits(rng, (50, 88)), _digits(rng, (50, 88))
    b[:5] = a[:5]  # equal rows for digits_ge
    b[5:10, 40:] = a[5:10, 40:]  # equal high halves
    pred = rng.integers(0, 2, size=50).astype(bool)
    c = _digits(rng, 4)
    A, B = jnp.asarray(a), jnp.asarray(b)
    _eq(td.add_digits(_u8(a), _u8(b)), jax.jit(jd.add_digits)(A, B))
    _eq(td.sub_digits(_u8(a), _u8(b)), jax.jit(jd.sub_digits)(A, B))
    _eq(td.select_digits(torch.from_numpy(pred), _u8(a), _u8(b)),
        jax.jit(jd.select_digits)(jnp.asarray(pred), A, B))
    _eq(td.digits_ge(_u8(a), _u8(b)), jax.jit(jd.digits_ge)(A, B))
    _eq(td.scalar_mul_digits(_u8(a), _u8(c)), jax.jit(jd.scalar_mul_digits)(A, jnp.asarray(c)))


def test_mod_p_and_sub_mod_p():
    rng = np.random.default_rng(12)
    a = _digits(rng, (30, 88))
    a[0] = 255
    _eq(td.mod_p(_u8(a)), jax.jit(jd.mod_p)(jnp.asarray(a)))
    x, y = _words(rng, 100, P), _words(rng, 100, P)
    _eq(td.sub_mod_p(_t(x), _t(y)), jax.jit(jd.sub_mod_p)(jnp.asarray(x), jnp.asarray(y)))


def test_ints_to_digit_matrix():
    xs = [0, 1, (1 << 704) - 1, 12345678901234567890]
    np.testing.assert_array_equal(td.ints_to_digit_matrix(xs), jd.ints_to_digit_matrix(xs))
    assert [td.digits_to_int(r) for r in td.ints_to_digit_matrix(xs)] == xs


def test_digit_widths_match_jax():
    """DIGITS (mod-2^704 width) and FULL_DIGITS (PRG bytes a value)."""
    assert (td.DIGITS, td.FULL_DIGITS) == (jd.DIGITS, jd.FULL_DIGITS) == (88, 92)
