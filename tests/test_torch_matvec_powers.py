"""K8 (matvec_mod_p, and its at-s form poly_eval_mod_p) and K9
(powers_mod_p, and its messages form message_powers),
c_lwe_snarks_tpu_torch/csrc/modp.cu: their plain versions against the JAX
package's functions and Python ints, and numpy models of each kernel's
decomposition, tolerance 0.

The models follow the kernels with the .cu's own constants: K8's blocks
of kRows rows and a column segment, each thread's 64-bit sum of products
folded to < 2^35, the warp and block sums, the split rows' residues added
in split order; in the at-s form each thread's operand made from s by
square and multiply at its first column, then one mulmod by s^kThreads a
column; K9's per-thread square and multiply with the device's mulmod, and
alpha times it in the messages form.  Each asserts the bounds the .cu
states.  The kernels themselves
are held against the plain versions on a GPU in tests/test_torch_cuda.py
and chip_smoke.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.ops import modp as jmodp
from c_lwe_snarks_tpu_torch.ops import modp as tmodp

torch.set_num_threads(1)

P = (1 << 32) - 5
SOURCE = (pathlib.Path(tmodp.__file__).resolve().parent.parent / "csrc" / "modp.cu").read_text()
_jmatvec = jax.jit(jmodp.matvec_mod_p)
_jpowers = jax.jit(jmodp.powers_mod_p, static_argnums=1)
_jpoly_eval = jax.jit(jmodp.poly_eval_mod_p)
_jmulmod = jax.jit(jmodp.mulmod_p)


def constant(name: str) -> int:
    """An integer constexpr of modp.cu."""
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


THREADS, ROWS, WARPS = constant("kThreads"), constant("kRows"), constant("kThreads") // 32
M32 = np.uint64(0xFFFFFFFF)


def fold35(x: np.ndarray) -> np.ndarray:
    """The .cu's fold35: 5 * (x >> 32) + (x & (2^32 - 1)), < 6 * 2^32."""
    return np.uint64(5) * (x >> np.uint64(32)) + (x & M32)


def reduce53(x: np.ndarray) -> np.ndarray:
    assert int(x.max(initial=0)) < 1 << 53
    r = fold35(x)
    for _ in range(2):
        r = np.where(r >= P, r - np.uint64(P), r)
    return r


def k8_model(v: np.ndarray, w: np.ndarray) -> np.ndarray:
    """matvec_kernel on [rows, d]: grid (row groups, splits), segment seg."""
    rows, d = v.shape
    splits = tmodp.matvec_splits(rows, d)
    seg = -(-(-(-d // splits)) // THREADS) * THREADS
    groups = -(-rows // ROWS)
    assert splits * seg >= d and seg % THREADS == 0
    # every thread's columns c0 + t, c0 + t + kThreads, ...: at most
    # ceil(seg / kThreads) products folded to < 6 * 2^32 each
    per_thread = seg // THREADS
    assert per_thread * (6 << 32) < 1 << 64
    vp = np.zeros((groups * ROWS, splits * seg), np.uint64)
    vp[:rows, :d] = v
    wp = np.zeros(splits * seg, np.uint64)
    wp[:d] = w
    prod = vp.reshape(groups, ROWS, splits, per_thread, THREADS) * wp.reshape(splits, per_thread, THREADS)
    acc = fold35(prod).sum(axis=3)  # [groups, kRows, splits, kThreads]: the thread sums
    lanes = fold35(acc).reshape(groups, ROWS, splits, WARPS, 32)
    assert int(lanes.max()) < 1 << 35
    warp = lanes.sum(axis=4)
    assert int(warp.max()) < 1 << 40
    block = warp.sum(axis=3)
    assert int(block.max()) < 1 << 43
    res = reduce53(block)  # [groups, kRows, splits]
    if splits > 1:  # the last block of a row group: the splits in order
        total = np.zeros(res.shape[:2], np.uint64)
        for k in range(splits):
            total += res[:, :, k]
        res = reduce53(total)
    return res.reshape(-1)[:rows].astype(np.int64)


def python_matvec(v: np.ndarray, w: np.ndarray) -> np.ndarray:
    wl = [int(x) for x in w]
    return np.array([sum(int(a) * b for a, b in zip(row, wl)) % P for row in v], np.int64)


def test_k8_k9_constants_match_the_port():
    """The wrapper's splits and the kernel's block agree."""
    assert ROWS == tmodp.MATVEC_ROWS and tmodp.MATVEC_MIN_SEGMENT % THREADS == 0
    assert tmodp.matvec_splits(21845, 1 << 15) == 1  # setup's v: the row groups fill the card
    assert tmodp.matvec_splits(1, 1 << 15) == 16  # t and the verifier's rows
    assert tmodp.matvec_splits(1, (1 << 21) + 8) == -(-((1 << 21) + 8) // tmodp.MATVEC_MIN_SEGMENT)
    assert tmodp.matvec_splits(5462, 1 << 15) == 1  # a rank's rows at W = 4


@pytest.mark.parametrize("d", [1, 7, 8, 33, 32768, 32769])
def test_matvec_matches_jax_at_p_minus_1(d):
    """Every entry p - 1, d on both sides of the JAX package's branches
    (d < 8 and d > 32,768 take its mulmod tree)."""
    v = np.full((3, d), P - 1, np.uint32)
    w = np.full(d, P - 1, np.uint32)
    want = np.asarray(_jmatvec(jnp.asarray(v), jnp.asarray(w))).astype(np.int64)
    tv, tw = torch.from_numpy(v.astype(np.int64)), torch.from_numpy(w.astype(np.int64))
    np.testing.assert_array_equal(tmodp.matvec_mod_p(tv, tw).numpy(), want)
    np.testing.assert_array_equal(k8_model(v.astype(np.uint64), w.astype(np.uint64)), want)
    assert int(want[0]) == (d * (P - 1) ** 2) % P


@pytest.mark.parametrize("rows,d", [(1, (1 << 21) + 8), (3, 40000)])
def test_matvec_any_d_matches_jax(rows, d):
    """The repaired fault: d >= 2^21 (the port raised AssertionError there)
    and d past 32,768, seeded from numpy; the JAX function, the port's
    plain version, K8's model and the Python-int sum agree."""
    rng = np.random.default_rng(rows + d)
    v = rng.integers(0, P, size=(rows, d), dtype=np.uint64).astype(np.uint32)
    w = rng.integers(0, P, size=d, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(_jmatvec(jnp.asarray(v), jnp.asarray(w))).astype(np.int64)
    got = tmodp.matvec_mod_p(torch.from_numpy(v.astype(np.int64)), torch.from_numpy(w.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(python_matvec(v, w), want)
    np.testing.assert_array_equal(k8_model(v.astype(np.uint64), w.astype(np.uint64)), want)


@pytest.mark.parametrize("rows,d", [(5, 8), (21, 1 << 15), (4229, 16), (2, 300), (1027, 64)])
def test_k8_model_matches_jax(rows, d):
    """The kernel's decomposition: one row group, a ragged last group, row
    groups that fill the card (no split), single rows split over blocks;
    the first row at p - 1 everywhere."""
    rng = np.random.default_rng(rows * d)
    v = rng.integers(0, P, size=(rows, d), dtype=np.uint64).astype(np.uint32)
    w = rng.integers(0, P, size=d, dtype=np.uint64).astype(np.uint32)
    v[0], w[: d // 2] = P - 1, P - 1
    want = np.asarray(_jmatvec(jnp.asarray(v), jnp.asarray(w))).astype(np.int64)
    np.testing.assert_array_equal(k8_model(v.astype(np.uint64), w.astype(np.uint64)), want)
    got = tmodp.matvec_mod_p(torch.from_numpy(v.astype(np.int64)), torch.from_numpy(w.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_matvec_batch_dimensions():
    """v [..., m, d] -> [..., m]; a 1-D v is one row."""
    rng = np.random.default_rng(9)
    v = rng.integers(0, P, size=(2, 3, 50), dtype=np.int64)
    w = rng.integers(0, P, size=50, dtype=np.int64)
    got = tmodp.matvec_mod_p(torch.from_numpy(v), torch.from_numpy(w))
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got.numpy().reshape(-1), python_matvec(v.reshape(-1, 50), w))
    one = tmodp.matvec_mod_p(torch.from_numpy(v[0, 0]), torch.from_numpy(w))
    assert one.shape == () and int(one) == int(got[0, 0])


def device_mulmod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """aes_core.cuh's fold64_mod_p of the 64-bit product a * b."""
    x = a.astype(np.uint64) * b.astype(np.uint64)
    hi, lo = x >> np.uint64(32), x & M32
    t = hi * np.uint64(5) + lo
    tl = t & M32
    r = (tl + np.uint64(5) * (t >> np.uint64(32))) & M32
    r = np.where(r < tl, r + np.uint64(5), r)
    return np.where(r >= P, r - np.uint64(P), r)


def k9_model(s: int, count: int) -> np.ndarray:
    """powers_kernel: thread i computes s^i by square and multiply over i's bits."""
    e = np.arange(count, dtype=np.uint64)
    r = np.ones(count, np.uint64)
    base = np.full(count, s, np.uint64)
    while e.any():
        r = np.where(e & np.uint64(1), device_mulmod(r, base), r)
        base = device_mulmod(base, base)
        e = e >> np.uint64(1)
    return r.astype(np.int64)


@pytest.mark.parametrize("s", [0, 1, P - 1, 2718281828])
@pytest.mark.parametrize("count", [1, 2, 3, 1000, (1 << 15) + 1])
def test_powers_match_jax(s, count):
    """s in {0, 1, p - 1, random}, counts 1, 2, 3, 1,000 and 2^15 + 1: the
    plain version (doubling), K9's model and the JAX function."""
    want = np.asarray(_jpowers(jnp.uint32(s), count)).astype(np.int64)
    got = tmodp.powers_mod_p(torch.tensor(s, dtype=torch.int64), count)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(k9_model(s, count), want)
    assert int(want[-1]) == pow(s, count - 1, P)


def test_poly_eval_matches_jax():
    """Polynomials at s: K9's powers then K8's rows."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, P, size=(3, 1000), dtype=np.uint64).astype(np.uint32)
    s = 987654321
    want = np.asarray(_jpoly_eval(jnp.asarray(x), jnp.uint32(s))).astype(np.int64)
    got = tmodp.poly_eval_mod_p(torch.from_numpy(x.astype(np.int64)), torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), want)
    powers = k9_model(s, 1000).astype(np.uint64)
    np.testing.assert_array_equal(k8_model(x.astype(np.uint64), powers), want)


def device_pow(b: np.ndarray, e: np.ndarray) -> np.ndarray:
    """modp.cu's pow_mod_p: square and multiply over e's bits, elementwise."""
    e = e.astype(np.uint64).copy()
    b = b.astype(np.uint64).copy()
    r = np.ones(e.shape, np.uint64)
    while e.any():
        r = np.where(e & np.uint64(1), device_mulmod(r, b), r)
        b = device_mulmod(b, b)
        e = e >> np.uint64(1)
    return r


def k8_at_s_operand(s: int, rows: int, d: int) -> np.ndarray:
    """The at-s form's w as its threads make it: thread t of split y starts
    at column y * seg + t with s^that by square and multiply, then steps
    one mulmod by s^kThreads a column; every column's word, in order."""
    splits = tmodp.matvec_splits(rows, d)
    seg = -(-(-(-d // splits)) // THREADS) * THREADS
    first = np.arange(splits)[:, None] * seg + np.arange(THREADS)  # [splits, kThreads]
    cur = device_pow(np.full(first.shape, s, np.uint64), first)
    step = device_pow(np.array([s], np.uint64), np.array([THREADS]))
    w = np.zeros(splits * seg, np.uint64)
    for u in range(seg // THREADS):
        w[first + u * THREADS] = cur
        cur = device_mulmod(cur, step)
    return w[:d]


@pytest.mark.parametrize("s", [0, 1, P - 1, 2718281828])
@pytest.mark.parametrize("count", [1, 2, 3, (1 << 15) + 1])
def test_message_powers_match_jax(s, count):
    """K9's messages form: s^i then alpha s^i against the JAX package's
    powers_mod_p and mulmod_p (setup's first 2d plaintexts), written into
    the head of a larger buffer with out=; the model: the powers kernel's
    square and multiply, and alpha times each by the device's mulmod."""
    alpha = 3141592653 if s != 1 else P - 1
    pw = _jpowers(jnp.uint32(s), count)
    want = np.concatenate([np.asarray(pw), np.asarray(_jmulmod(jnp.uint32(alpha), pw))]).astype(np.int64)
    ts, ta = torch.tensor(s, dtype=torch.int64), torch.tensor(alpha, dtype=torch.int64)
    np.testing.assert_array_equal(tmodp.message_powers(ts, ta, count).numpy(), want)
    buf = torch.full((2 * count + 3,), -1, dtype=torch.int64)
    tmodp.message_powers(ts, ta, count, out=buf[: 2 * count])
    np.testing.assert_array_equal(buf[: 2 * count].numpy(), want)
    assert (buf[2 * count :] == -1).all()
    powers = k9_model(s, count).astype(np.uint64)
    model = np.concatenate([powers, device_mulmod(np.full(count, alpha, np.uint64), powers)])
    np.testing.assert_array_equal(model.astype(np.int64), want)


@pytest.mark.parametrize("rows,d", [(2, 1), (2, 7), (1, 8), (2, 1 << 15), (1, (1 << 21) + 8), (5, 999)])
def test_poly_eval_at_s_matches_jax(rows, d):
    """K8's at-s form (the verifier's t(s) and v_0(s) as two stacked rows):
    the plain version and the model, whose operand is made by the threads'
    stepping, against the JAX package's poly_eval_mod_p at d < 8, 2^15 and
    past 2^21; s = p - 1 on the first case of each shape."""
    rng = np.random.default_rng(rows + d)
    x = rng.integers(0, P, size=(rows, d), dtype=np.uint64).astype(np.uint32)
    x[0, : d // 2] = P - 1
    for s in (P - 1, int(rng.integers(2, P))):
        want = np.asarray(_jpoly_eval(jnp.asarray(x), jnp.uint32(s))).astype(np.int64)
        got = tmodp.poly_eval_mod_p(torch.from_numpy(x.astype(np.int64)), torch.tensor(s))
        np.testing.assert_array_equal(got.numpy(), want)
        w = k8_at_s_operand(s, rows, d)
        if d <= 1 << 15:
            np.testing.assert_array_equal(w.astype(np.int64), k9_model(s, d))
        else:
            assert [int(w[i]) for i in (0, 1, d - 1)] == [1, s, pow(s, d - 1, P)]
        np.testing.assert_array_equal(k8_model(x.astype(np.uint64), w), want)
