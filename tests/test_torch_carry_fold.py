"""K10 (the carry fold: its planes, b-row, MAC-plane and smudge forms),
c_lwe_snarks_tpu_torch/csrc/digits.cu: the plain versions against the JAX
package's carry_fold, encrypt_b, fused evaluation epilogue and smudge, and
a numpy model of the kernel's lanes, shuffles and ballots, tolerance 0.

The model follows the kernel with the .cu's own constants: a warp holds
32 / kLanes rows, a row's group of kLanes lanes, lane g owning the kPer
contiguous positions kPer g ... of each pass of kSeg positions; a lane
walks its own positions (round 0), takes the carry of the lane below by
shuffle twice (rounds 1 and 2), and the last one-bit ripple is resolved
from three warp ballots (round 3).  Every 64-bit add is checked not to
wrap.  Each form's loads are modelled as the .cu's functors load them:
the b-row form's p * e from the lane's error bytes and the three below it
(a shuffle), the MAC-plane form's low bytes and high parts with the four
positions that land on the lane above (shuffles), the smudge form's
+-p * s from the draw's bytes and the three below.  The kernel itself is
held against the plain versions on a GPU in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.models import lwe as jlwe
from c_lwe_snarks_tpu.ops import digits as jdg
from c_lwe_snarks_tpu.utils import params as params_mod
from c_lwe_snarks_tpu_torch.models import lwe as tlwe
from c_lwe_snarks_tpu_torch.models import snark as tsnark
from c_lwe_snarks_tpu_torch.ops import digits as tdg

torch.set_num_threads(1)

P = (1 << 32) - 5
CSRC = pathlib.Path(tdg.__file__).resolve().parent.parent / "csrc"
SOURCE = (CSRC / "digits.cu").read_text() + (CSRC / "carry.cuh").read_text()  # the fold's header
_jfold = jax.jit(jdg.carry_fold, static_argnums=1)


def constant(name: str) -> int:
    """An integer constexpr of digits.cu or its fold's header (a literal)."""
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


LANES, PER, THREADS, DIGITS = (constant(n) for n in ("kLanes", "kPer", "kThreads", "kDigits"))
SEG = LANES * PER
GROUPS = 32 // LANES  # rows of a warp
BLOCK_MASK = np.uint64((1 << (8 * PER)) - 1)
U = np.uint64


def add(a, b):
    """a + b in uint64, asserting that no element wraps past 2^64."""
    s = a + b
    assert (s >= a).all(), "a 64-bit add wrapped"
    return s


def shfl_up(v):
    """__shfl_up_sync(v, 1, kLanes) then zero below a group's lane 0:
    v [warps, 32] -> lane l takes lane l - 1 of its group."""
    out = np.zeros_like(v)
    g = np.arange(32) % LANES
    out[:, g > 0] = v[:, np.arange(32)[g > 0] - 1]
    return out


def ballot(pred, shift):
    """(__ballot_sync(pred) >> shift) & 0xFFFF: the group's ballot bits a lane sees."""
    bits = (pred.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(axis=1, dtype=np.uint64)
    return (bits[:, None] >> shift.astype(np.uint64)) & U(0xFFFF)


def fold_group(x, g, shift):
    """fold_group: x [warps, 32, kPer] -> (the lanes' six digits, carry out of the pass)."""
    d = np.zeros(x.shape[:2], np.uint64)
    c = np.zeros(x.shape[:2], np.uint64)
    for j in range(PER):  # round 0
        v = add(x[..., j], c)
        d |= (v & U(255)) << U(8 * j)
        c = v >> U(8)
    assert (c < U(1 << 57)).all()
    out = c.copy()
    for rnd, cap in ((1, 256), (2, 1)):  # rounds 1 and 2
        d = add(d, shfl_up(c))
        c = d >> U(8 * PER)
        d &= BLOCK_MASK
        out = add(out, c)
        assert int(c.max()) <= cap, rnd
    cb = ballot(c != 0, shift)  # round 3
    d = d + (((cb << U(1)) >> g) & U(1))
    assert (d <= BLOCK_MASK + U(1)).all()
    gen, prop = ballot(d > BLOCK_MASK, shift), ballot(d == BLOCK_MASK, shift)
    carries = ((gen | prop) + gen) ^ prop
    d = d + ((carries >> g) & U(1))
    out = add(out, carries >> U(LANES))
    return d & BLOCK_MASK, out


def k10_model(load, rows: int, ndigits: int, out=None) -> np.ndarray:
    """carry_fold_kernel over rows: load(r, p0, g) -> x [warps, 32, kPer]
    (uint64) with r, p0, g [warps, 32] the lanes' row, first position and
    place in the group; returns the digits [rows, ndigits] (into out, or
    a fresh array whose unstored bytes read 77)."""
    out = np.full((rows, ndigits), 77, np.uint8) if out is None else out
    warps = -(-rows // GROUPS)  # the rest of a block's warps leave at once
    lane = np.arange(32)
    g = np.broadcast_to((lane % LANES).astype(np.uint64), (warps, 32))
    shift = np.broadcast_to((lane & LANES).astype(np.uint64), (warps, 32))
    row = np.arange(warps)[:, None] * GROUPS + lane // LANES
    live = row < rows
    r = np.where(live, row, rows - 1)
    cin = np.zeros((warps, 32), np.uint64)
    for s0 in range(0, ndigits, SEG):
        p0 = s0 + PER * g.astype(np.int64)
        x = load(r, p0, g)
        assert x.dtype == np.uint64 and x.shape == (warps, 32, PER)
        x[..., 0] = np.where(g == 0, add(x[..., 0], cin), x[..., 0])
        d, carry = fold_group(x, g, shift)
        for j in range(PER):
            keep = live & (p0 + j < ndigits)
            out[r[keep], (p0 + j)[keep]] = ((d[keep] >> U(8 * j)) & U(255)).astype(np.uint8)
        cin = carry.reshape(warps, GROUPS, LANES)[:, :, LANES - 1].repeat(LANES, axis=1)
    return out


def run_of(v: np.ndarray, r, p0, lim: int) -> np.ndarray:
    """load_run: v[r, p0 + j] for p0 + j < lim, else 0, as uint64 [..., kPer]."""
    idx = p0[..., None] + np.arange(PER)
    ok = idx < lim
    vals = v[r[..., None], np.minimum(idx, v.shape[1] - 1)]
    return np.where(ok, vals.astype(np.uint64), U(0))


def with_below(v: np.ndarray) -> np.ndarray:
    """with_below: the lane's bytes, with the lane below's top three first
    (one shuffle of their packed word): [..., 3 + kPer]."""
    top = v[..., PER - 3] | v[..., PER - 2] << U(8) | v[..., PER - 1] << U(16)
    below = shfl_up(top)
    return np.concatenate([np.stack([below & U(255), (below >> U(8)) & U(255), below >> U(16)], -1),
                           v], axis=-1)


def p_times(E: np.ndarray, j: int) -> np.ndarray:
    return U(0xFB) * E[..., 3 + j] + U(0xFF) * (E[..., 2 + j] + E[..., 1 + j] + E[..., j])


def planes_load(acc: np.ndarray, ndigits: int):
    """The planes form: int64 or int32 [rows, K], positions past min(K, ndigits) read 0."""
    lim = min(acc.shape[1], ndigits)
    return lambda r, p0, g: run_of(acc, r, p0, lim)


def brow_load(lo, hi, errs, msgs):
    """The b-row form: lo + 16 hi + p * e + m's bytes in lane 0."""
    def load(r, p0, g):
        a, b = run_of(lo, r, p0, DIGITS), run_of(hi, r, p0, DIGITS)
        E = with_below(run_of(errs, r, p0, DIGITS))
        msg = np.where(g == 0, msgs[r].astype(np.uint64), U(0))
        x = np.empty(a.shape, np.uint64)
        for j in range(PER):
            m_j = (msg >> U(8 * j)) & U(255) if j < 4 else U(0)
            x[..., j] = a[..., j] + U(16) * b[..., j] + p_times(E, j) + m_j
        return x
    return load


def mac_load(acc_a: np.ndarray, acc_b: np.ndarray):
    """The MAC-plane form: row (kk, i) of [k, n+1], plane c at a shift of
    c positions, low byte and high part; four positions handed up."""
    _, k, n, _ = acc_a.shape

    def load(r, p0, g):
        kk, i = r // (n + 1), r % (n + 1)
        acc = np.zeros(r.shape + (PER + 4,), np.uint64)
        for c in range(4):
            va = run_of(acc_a[c].reshape(k * n, DIGITS), kk * n + np.minimum(i, n - 1), p0, DIGITS) \
                if n else 0
            vb = run_of(acc_b[c], kk, p0, DIGITS)
            v = np.where((i < n)[..., None], va, vb)
            for j in range(PER):
                acc[..., j + c] = add(acc[..., j + c], v[..., j] & U(255))
                acc[..., j + c + 1] = add(acc[..., j + c + 1], v[..., j] >> U(8))
        x = acc[..., :PER].copy()
        for q in range(4):
            x[..., q] = add(x[..., q], shfl_up(acc[..., PER + q]))
        return x
    return load


def smudge_load(b, draws, targets):
    """The smudge form: b rows (uint8 [rows, 88]) + sigma p s for each draw
    on the row (draws uint8 [S, L + 1]: L digits and the sign byte, low bit
    0 positive); negative draws as 2^24 - p s and the constant."""
    s_len = draws.shape[1] - 1
    signs = draws[:, -1]

    def load(r, p0, g):
        x = run_of(b, r, p0, DIGITS)
        for i, tgt in enumerate(targets):
            E = with_below(run_of(draws[i : i + 1], np.zeros_like(r), p0, s_len))
            on = (r == tgt) if tgt != 15 else np.ones(r.shape, bool)
            pos = (int(signs[i]) & 1) == 0
            for j in range(PER):
                y = p_times(E, j)
                t = p0 + j
                k_t = np.where(t == 0, 256, np.where(t < 3, 255, 254)).astype(np.uint64)
                x[..., j] = np.where(on, add(x[..., j], y if pos else U(1 << 24) - y + k_t), x[..., j])
        return x
    return load


def python_fold(acc: np.ndarray, ndigits: int) -> np.ndarray:
    """sum_t acc[..., t] * 256^t mod 256^ndigits as digits, by Python ints."""
    flat = acc.reshape(-1, acc.shape[-1])
    out = np.zeros((flat.shape[0], ndigits), np.uint8)
    for i, row in enumerate(flat):
        x = sum(int(v) << (8 * t) for t, v in enumerate(row)) % (1 << (8 * ndigits))
        out[i] = np.frombuffer(x.to_bytes(ndigits, "little"), np.uint8)
    return out.reshape(*acc.shape[:-1], ndigits)


def to_int(row) -> int:
    return int.from_bytes(np.asarray(row, np.uint8).tobytes(), "little")


def test_k10_layout_covers_each_position_once():
    """The lane layout: the lanes of a group own kPer contiguous positions
    each, side by side, so a pass covers kSeg contiguous positions and the
    passes cover [0, ndigits) once; a warp's groups take consecutive rows
    and a block kThreads / kLanes; a lane's loads are pairs of adjacent
    positions, aligned for 88-position rows of int64 (16 bytes), int32 (8)
    and uint8 (2); the 88-digit forms are one pass; a lane's six digits
    and its round-0 carry fit the 64-bit adds (2^48 + 2^57 < 2^64)."""
    assert 32 % LANES == 0 and PER % 2 == 0 and THREADS % 32 == 0
    for nd in (1, 3, 65, 80, 88, 96, 97, 200):
        seen = []
        for s0 in range(0, nd, SEG):
            for g in range(LANES):
                own = [s0 + PER * g + j for j in range(PER)]
                assert own == list(range(own[0], own[0] + PER))  # contiguous a lane
                seen += [t for t in own if t < nd]
        assert seen == list(range(nd))  # each position once, lanes in order
    assert DIGITS <= SEG  # the b-row, MAC-plane and smudge forms: one pass
    for size in (8, 4, 1):
        for g in range(LANES):
            for q in range(0, PER, 2):
                assert (size * (PER * g + q)) % (2 * size) == 0  # pair-aligned from the row's start
        assert (size * DIGITS) % (2 * size) == 0  # and every row starts pair-aligned
    assert (1 << (8 * PER)) + (1 << 57) < 1 << 64
    assert THREADS // LANES == 16 and GROUPS == 2


@pytest.mark.parametrize("case", ["random", "worst", "ripple", "ripples", "truncate"])
def test_carry_fold_matches_jax(case):
    """The plain version and K10's model against the JAX function on its
    domain (int32 planes): random planes, every plane 2^31 - 1, the worst
    ripple (256 then 87 positions of 255), ripples stopped at every
    position, and ndigits short of K (truncation)."""
    rng = np.random.default_rng(len(case))
    nd = 88
    if case == "random":
        acc = rng.integers(0, 1 << 31, size=(45, 88), dtype=np.int64)
    elif case == "worst":
        acc = np.full((3, 88), (1 << 31) - 1, np.int64)
    elif case == "ripple":
        acc = np.full((2, 88), 255, np.int64)
        acc[:, 0] = 256
        acc[1, 87] = 0
    elif case == "ripples":
        acc = np.full((88, 88), 255, np.int64)
        acc[:, 0] = 256
        acc[np.arange(1, 88), np.arange(1, 88)] = 254
    else:
        acc = rng.integers(0, 1 << 31, size=(33, 88), dtype=np.int64)
        nd = 80
    acc = acc.astype(np.int32)
    want = np.asarray(_jfold(jnp.asarray(acc), nd))
    np.testing.assert_array_equal(tdg.carry_fold(torch.from_numpy(acc), nd).numpy(), want)
    np.testing.assert_array_equal(tdg.carry_fold(torch.from_numpy(acc.astype(np.int64)), nd).numpy(), want)
    np.testing.assert_array_equal(k10_model(planes_load(acc, nd), acc.shape[0], nd), want)
    np.testing.assert_array_equal(python_fold(acc, nd), want)


@pytest.mark.parametrize("rows,k,nd,bits", [
    (33, 88, 88, 47), (161, 88, 88, 62), (5, 100, 88, 40), (40, 70, 88, 47), (1, 1, 3, 40),
    (32, 65, 65, 47)])
def test_k10_model_beyond_the_jax_domain(rows, k, nd, bits):
    """int64 planes up to 2^47 and 2^62, K past and short of ndigits
    (zero-extended), ragged warps and blocks, a lane's run cut by K: the
    model and the plain version equal Python ints."""
    rng = np.random.default_rng(rows + k + bits)
    acc = rng.integers(0, 1 << bits, size=(rows, k), dtype=np.int64)
    acc[0] = (1 << bits) - 1
    want = python_fold(acc, nd)
    np.testing.assert_array_equal(k10_model(planes_load(acc, nd), rows, nd), want)
    got = tdg.carry_fold(torch.from_numpy(acc), nd)
    assert got.shape == (rows, nd)
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_planes(case: str, rows: int):
    rng = np.random.default_rng(rows)
    if case == "int64max":  # every plane 2^63 - 1
        return np.full((rows, 88), (1 << 63) - 1, np.int64), 88
    if case == "worst_ripple":  # 256, then 87 positions of 255 (every row)
        acc = np.full((rows, 88), 255, np.int64)
        acc[:, 0] = 256
        return acc, 88
    if case == "ripples":  # a ripple stopped at each position, one a row
        acc = np.full((rows, 88), 255, np.int64)
        acc[:, 0] = 256
        acc[np.arange(rows), np.arange(rows) % 88] = 254
        acc[0, 0] = 256
        return acc, 88
    if case == "int32max":
        return np.full((rows, 88), (1 << 31) - 1, np.int32), 88
    if case == "k_short":  # K < ndigits
        return rng.integers(0, 1 << 63, size=(rows, 61), dtype=np.int64), 88
    if case == "k_long":  # K > ndigits
        return rng.integers(0, 1 << 63, size=(rows, 120), dtype=np.int64), 88
    if case == "two_passes":  # ndigits past one pass of kSeg positions
        acc = rng.integers(0, 1 << 63, size=(rows, 150), dtype=np.int64)
        acc[0, :] = (1 << 63) - 1
        return acc, 140
    raise AssertionError(case)


@pytest.mark.parametrize("rows", [1, 31, 33])
@pytest.mark.parametrize("case", ["int64max", "worst_ripple", "ripples", "int32max", "k_short",
                                  "k_long", "two_passes"])
def test_k10_model_at_the_edges(case, rows):
    """The planes form at its edges, 1, 31 and 33 rows (a lone group, a
    ragged warp, a ragged block): int64 planes at 2^63 - 1, the worst
    ripple, ripples stopped at every position, int32 at 2^31 - 1, K short
    of and past ndigits, two passes: model, plain version and Python ints
    agree."""
    acc, nd = _edge_planes(case, rows)
    want = python_fold(acc, nd)
    np.testing.assert_array_equal(k10_model(planes_load(acc, nd), rows, nd), want)
    np.testing.assert_array_equal(tdg.carry_fold(torch.from_numpy(acc), nd).numpy(), want)


def test_k10_model_at_the_provers_rows():
    """7,355 rows of the prover's planes shape [5, 1471, 88] with a ripple
    in every row: model against the plain version."""
    rng = np.random.default_rng(7355)
    acc = rng.integers(0, 1 << 40, size=(7355, 88), dtype=np.int64)
    acc[::3] = 255
    acc[::3, 0] = 256
    want = tdg.carry_fold(torch.from_numpy(acc)).numpy()
    np.testing.assert_array_equal(k10_model(planes_load(acc, 88), 7355, 88), want)


def _enc_inputs(seed: int, batch: int, n: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(batch, n, 88), dtype=np.uint8)
    sk = rng.integers(0, 256, size=(n, 88), dtype=np.uint8)
    msgs = rng.integers(0, P, size=batch, dtype=np.uint64).astype(np.uint32)
    errs = np.zeros((batch, 88), np.uint8)
    errs[:, :69] = rng.integers(0, 256, size=(batch, 69), dtype=np.uint8)
    a[0], sk[:], errs[0, :69], msgs[0] = 255, sk | 0x80, 255, P - 1
    return a, sk, msgs, errs


def _nibble_planes(a: np.ndarray, sk: np.ndarray):
    """K4's output for these a-vectors: v_lo / v_hi [B, 88] with sk's low
    and high nibbles, sum_{j, k + l = t} a_j[k] * nibble(sk[j, l])."""
    at = torch.from_numpy(a).to(torch.float64).transpose(1, 2)  # [B, 88, n]
    sk_t = torch.from_numpy(sk).to(torch.int64)
    planes = [tdg.antidiag_sums((at @ nib.to(torch.float64)).to(torch.int64))[..., :88]
              for nib in (sk_t & 15, sk_t >> 4)]
    assert max(int(p.max()) for p in planes) < 1 << 31
    return planes


@pytest.mark.parametrize("batch,n", [(7, 6), (33, 19)])
def test_b_rows_match_jax_encrypt_b(batch, n):
    """The b-row form, plain and modelled, against the JAX package's
    encrypt_b on the same a, sk, messages and errors (its epilogue: the
    dot's fold, p * e, m, carry_fold); the port's encrypt_b too."""
    a, sk, msgs, errs = _enc_inputs(batch + n, batch, n)
    jp = params_mod.custom(d=16, m=8, n=n)
    want = np.asarray(jax.jit(jlwe.encrypt_b, static_argnums=4)(
        jnp.asarray(a), jnp.asarray(sk), jnp.asarray(msgs), jnp.asarray(errs), jp))
    v_lo, v_hi = _nibble_planes(a, sk)
    tm, te = torch.from_numpy(msgs.astype(np.int64)), torch.from_numpy(errs)
    np.testing.assert_array_equal(tdg.carry_fold_b_rows(v_lo, v_hi, te, tm).numpy(), want)
    np.testing.assert_array_equal(tdg.b_rows_plain(v_lo.int(), v_hi.int(), te, tm).numpy(), want)
    from c_lwe_snarks_tpu_torch.utils.params import Params

    tp = Params(d=16, m=8, n=n)
    got = tlwe.encrypt_b(torch.from_numpy(a), torch.from_numpy(sk), tm, te, tp)
    np.testing.assert_array_equal(got.numpy(), want)
    got = k10_model(brow_load(v_lo.numpy(), v_hi.numpy(), errs, msgs.astype(np.int64)), batch, 88)
    np.testing.assert_array_equal(got, want)


def test_b_rows_at_the_nibble_bound():
    """Nibble planes at 2^31 - 1 everywhere, every error byte and message
    at its largest: plain against the model and Python ints."""
    B = 35
    lo = np.full((B, 88), (1 << 31) - 1, np.int64)
    hi = lo.copy()
    errs = np.full((B, 88), 255, np.uint8)
    msgs = np.full(B, (1 << 32) - 1, np.int64)
    val = [int(sum((int(lo[r, t]) + 16 * int(hi[r, t])) << (8 * t) for t in range(88))
               + P * int.from_bytes(errs[r].tobytes(), "little") + int(msgs[r])) % (1 << 704)
           for r in range(B)]
    want = np.stack([np.frombuffer(v.to_bytes(88, "little"), np.uint8) for v in val])
    got = tdg.carry_fold_b_rows(torch.from_numpy(lo).int(), torch.from_numpy(hi).int(),
                                torch.from_numpy(errs), torch.from_numpy(msgs))
    np.testing.assert_array_equal(got.numpy(), want)
    got = k10_model(brow_load(lo, hi, errs, msgs), B, 88)
    np.testing.assert_array_equal(got, want)


def _mac_inputs(k: int, n: int, top: int, seed: int):
    rng = np.random.default_rng(seed)
    acc_a = rng.integers(0, top, size=(4, k, n, 88), dtype=np.int64)
    acc_b = rng.integers(0, top, size=(4, k, 88), dtype=np.int64)
    acc_a[:, 0, : min(n, 2)] = top - 1
    acc_b[:, -1] = top - 1
    return acc_a, acc_b


def _mac_want(acc_a: np.ndarray, acc_b: np.ndarray) -> np.ndarray:
    """sum_c plane_c * 256^c mod 2^704 at every (evaluation, coordinate), by Python ints."""
    planes = np.concatenate([acc_a, acc_b[:, :, None, :]], axis=2)
    out = np.zeros(planes.shape[1:], np.uint8)
    for kk in range(planes.shape[1]):
        for i in range(planes.shape[2]):
            v = sum(int(x) << (8 * (t + c)) for c in range(4) for t, x in enumerate(planes[c, kk, i]))
            out[kk, i] = np.frombuffer((v % (1 << 704)).to_bytes(88, "little"), np.uint8)
    return out


@pytest.mark.parametrize("k,n", [(1, 3), (5, 6), (2, 0)])
def test_mac_planes_match_jax_epilogue(k, n):
    """The MAC-plane form's plain version and model against the JAX
    package's fused-evaluation epilogue (concatenate, combine_shift_planes,
    carry_fold; c_lwe_snarks_tpu/models/lwe.py:440-454) on int32 planes
    (its domain), k = 1, 5 and 2, odd and even n, and no a-part rows."""
    acc_a, acc_b = _mac_inputs(k, n, 1 << 31, k * 10 + n)

    @jax.jit
    def epilogue(a, b):
        planes = jnp.concatenate([a, b[:, :, None, :]], axis=2)
        return jdg.carry_fold(jdg.combine_shift_planes(planes))

    want = np.asarray(epilogue(jnp.asarray(acc_a.astype(np.int32)), jnp.asarray(acc_b.astype(np.int32))))
    got = tdg.fold_mac_planes(torch.from_numpy(acc_a), torch.from_numpy(acc_b))
    assert got.shape == (k, n + 1, 88)
    np.testing.assert_array_equal(got.numpy(), want)
    model = k10_model(mac_load(acc_a, acc_b), k * (n + 1), 88).reshape(k, n + 1, 88)
    np.testing.assert_array_equal(model, want)


@pytest.mark.parametrize("k,n", [(1, 3), (5, 7)])
def test_mac_planes_at_the_int64_bound(k, n):
    """Planes at 2^63 - 1 and random int64 planes (past the JAX package's
    int32): the plain version and the model against Python ints."""
    acc_a, acc_b = _mac_inputs(k, n, 1 << 63, k + n)
    acc_a[:, :, 1] = (1 << 63) - 1
    want = _mac_want(acc_a, acc_b)
    np.testing.assert_array_equal(
        tdg.fold_mac_planes(torch.from_numpy(acc_a), torch.from_numpy(acc_b)).numpy(), want)
    model = k10_model(mac_load(acc_a, acc_b), k * (n + 1), 88).reshape(k, n + 1, 88)
    np.testing.assert_array_equal(model, want)


def test_eval_epilogue_is_the_mac_plane_form():
    """lwe.eval_poly_multi's fused branch folds through fold_mac_planes:
    its result equals the plain epilogue on the same K3 planes and b-row MAC."""
    from c_lwe_snarks_tpu_torch.ops import eval_fused, sampling
    from c_lwe_snarks_tpu_torch.utils.params import Params

    tp = Params(d=16, m=8, n=5)
    key = sampling.PRGKey(bytes(range(40)), "cpu")
    rng = np.random.default_rng(3)
    coeffs = torch.from_numpy(rng.integers(0, P, size=(3, 16), dtype=np.int64))
    b_rows = torch.from_numpy(rng.integers(0, 256, size=(16, 92), dtype=np.uint8))
    acc_a = eval_fused.eval_mac_planes(key, 40, coeffs, tp.n, tp.ctr_ct)
    cb = tlwe.u32_to_bytes(coeffs)
    acc_b = tdg.u8_matmul(cb.permute(1, 0, 2).reshape(16, 12).T, b_rows[:, :88]) \
        .reshape(3, 4, 88).permute(1, 0, 2)
    want = tdg.carry_fold_plain(tdg.combine_shift_planes(torch.cat([acc_a, acc_b[:, :, None]], 2)))
    got = tlwe.eval_poly_multi(key, 40, b_rows, coeffs, tp, impl="fused")
    assert torch.equal(got, want)


def _smudge_inputs(seed: int, n: int, s_kind: str = "random"):
    rng = np.random.default_rng(seed)
    evals = rng.integers(0, 256, size=(5, n + 1, 88), dtype=np.uint8)
    draws = rng.integers(0, 256, size=(5, 81), dtype=np.uint8)
    if s_kind == "zero":
        draws[:, :80] = 0
    elif s_kind == "max":  # s = 2^640 - 1
        draws[:, :80] = 255
    evals[1, n] = 255  # b rows near the wrap of 2^704 and at zero
    evals[2, n] = 0
    return evals, draws


def _jax_smudges(evals: np.ndarray, draws: np.ndarray, n: int) -> np.ndarray:
    """Five sequential JAX smudge calls in the prover's draw order."""
    jp = params_mod.custom(d=16, m=8, n=n)
    step = jax.jit(lambda ct, s, pos: jlwe.smudge(ct, s, pos, jp))
    out = [jnp.asarray(e) for e in evals]
    for i, e in enumerate(tsnark.SMUDGE_TARGETS):
        s = np.zeros(88, np.uint8)
        s[:80] = draws[i, :80]
        out[e] = step(out[e], jnp.asarray(s), jnp.bool_((draws[i, 80] & 1) == 0))
    return np.stack([np.asarray(x) for x in out])


@pytest.mark.parametrize("signs", range(0, 32, 3))
def test_smudge_draws_match_jax(signs):
    """The smudge form's plain version and model against five sequential
    JAX smudge calls (h, hat_h, hat_v, v_w, v_w; b_w never), over sign
    patterns of the five draws (bit i: draw i negative)."""
    n = 3
    evals, draws = _smudge_inputs(signs, n)
    draws[:, 80] = [(signs >> i) & 1 | (draws[i, 80] & 0xFE) for i in range(5)]
    want = _jax_smudges(evals, draws, n)
    got = tdg.smudge_draws(torch.from_numpy(evals.copy()), torch.from_numpy(draws),
                           tsnark.SMUDGE_TARGETS)
    np.testing.assert_array_equal(got.numpy(), want)
    b = evals[:, n].copy()
    k10_model(smudge_load(b, draws, tsnark.SMUDGE_TARGETS), 4, 88, out=b[:4])
    np.testing.assert_array_equal(b, want[:, n])
    np.testing.assert_array_equal(want[:, :n], evals[:, :n])  # only the b rows change


@pytest.mark.parametrize("s_kind", ["zero", "max"])
def test_smudge_draws_at_the_edges(s_kind):
    """s = 0 and s = 2^640 - 1 under every sign pattern: plain version
    and model against Python ints."""
    n = 2
    for signs in range(32):
        evals, draws = _smudge_inputs(signs, n, s_kind)
        draws[:, 80] = [(signs >> i) & 1 for i in range(5)]
        b = [to_int(evals[e, n]) for e in range(5)]
        for i, e in enumerate(tsnark.SMUDGE_TARGETS):
            sp = to_int(draws[i, :80]) * P
            b[e] = (b[e] + (-sp if signs >> i & 1 else sp)) % (1 << 704)
        want = np.stack([np.frombuffer(x.to_bytes(88, "little"), np.uint8) for x in b])
        got = tdg.smudge_draws(torch.from_numpy(evals.copy()), torch.from_numpy(draws),
                               tsnark.SMUDGE_TARGETS)
        np.testing.assert_array_equal(got[:, n].numpy(), want)
        rows = evals[:, n].copy()
        k10_model(smudge_load(rows, draws, tsnark.SMUDGE_TARGETS), 4, 88, out=rows[:4])
        np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("positive", [True, False])
def test_smudge_one_row_case_matches_jax(positive):
    """lwe.smudge (one draw on every b row of a batch of ciphertexts, the
    sign a bool tensor) against the JAX smudge, and the form's one-row
    case modelled (target 15: every row; the draw row as smudge_rows builds it)."""
    n = 4
    rng = np.random.default_rng(int(positive))
    ct = rng.integers(0, 256, size=(3, n + 1, 88), dtype=np.uint8)
    s = np.zeros(88, np.uint8)
    s[:80] = rng.integers(0, 256, size=80, dtype=np.uint8)
    jp = params_mod.custom(d=16, m=8, n=n)
    want = np.asarray(jax.jit(lambda c, x: jlwe.smudge(c, x, jnp.bool_(positive), jp))(
        jnp.asarray(ct), jnp.asarray(s)))
    from c_lwe_snarks_tpu_torch.utils.params import Params

    got = tlwe.smudge(torch.from_numpy(ct), torch.from_numpy(s), torch.tensor(positive),
                      Params(d=16, m=8, n=n))
    np.testing.assert_array_equal(got.numpy(), want)
    b = ct[:, n].copy()
    draw = np.append(s, np.uint8(not positive))[None]
    k10_model(smudge_load(b, draw, (15,)), 3, 88, out=b)
    np.testing.assert_array_equal(b, want[:, n])
