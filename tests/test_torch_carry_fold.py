"""K10 (carry_fold and its b-row form), c_lwe_snarks_tpu_torch/csrc/digits.cu:
the plain versions against the JAX package's carry_fold and encrypt_b,
and a numpy model of the kernel's row staging and carry, tolerance 0.

The model follows the kernel with the .cu's own constants: a warp owns 32
rows and stages kChunk positions of them at a time in a tile of row stride
kPad 8-byte words; a lane walks its row's chunk with a carry that is a
Python int checked against 2^64, writes the digits to a byte tile of row
stride kOutPad, and positions past K read 0.  The b-row form stages lo +
16 hi, and the error bytes in the digit tile; the walk adds p's bytes
times the last four error bytes (kept across chunks) and the message's
bytes, as the .cu does.  The kernel itself is held against the plain versions on a GPU in
tests/test_torch_cuda.py and chip_smoke.py.
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
from c_lwe_snarks_tpu_torch.ops import digits as tdg

torch.set_num_threads(1)

P = (1 << 32) - 5
SOURCE = (pathlib.Path(tdg.__file__).resolve().parent.parent / "csrc" / "digits.cu").read_text()
_jfold = jax.jit(jdg.carry_fold, static_argnums=1)


def constant(name: str) -> int:
    """An integer constexpr of digits.cu (a literal, or kChunk plus one)."""
    m = re.search(rf"constexpr int {name} = (kChunk \+ )?(\d+);", SOURCE)
    assert m, name
    return (CHUNK if m.group(1) else 0) + int(m.group(2))


CHUNK = constant("kChunk")
WARPS, PAD, OUT_PAD = constant("kWarps"), constant("kPad"), constant("kOutPad")
BATCH = constant("kBatch")


def python_fold(acc: np.ndarray, ndigits: int) -> np.ndarray:
    """sum_t acc[..., t] * 256^t mod 256^ndigits as digits, by Python ints."""
    flat = acc.reshape(-1, acc.shape[-1])
    out = np.zeros((flat.shape[0], ndigits), np.uint8)
    for i, row in enumerate(flat):
        x = sum(int(v) << (8 * t) for t, v in enumerate(row)) % (1 << (8 * ndigits))
        out[i] = np.frombuffer(x.to_bytes(ndigits, "little"), np.uint8)
    return out.reshape(*acc.shape[:-1], ndigits)


def k10_model(load, rows: int, k: int, ndigits: int, err=None, msg=None) -> np.ndarray:
    """carry_fold_kernel: load(row, t) -> the staged value (a Python int);
    the b-row form also stages err(row, t), the error byte, in the digit
    tile and adds p * e from the last four error bytes and msg(row)'s byte
    at t < 4 in the walk."""
    out = np.full((rows, ndigits), 77, np.uint8)  # stale bytes where nothing is stored
    pb = [(P >> (8 * c)) & 255 for c in range(4)]
    for row0 in range(0, rows, 32):  # a warp's rows; blocks of kWarps warps share nothing
        nr = min(32, rows - row0)
        carry = [0] * 32
        errs = [[0, 0, 0] for _ in range(32)]  # a lane's e at t - 1, t - 2, t - 3
        for c0 in range(0, ndigits, CHUNK):
            cw = min(CHUNK, ndigits - c0)
            xs = [[0] * PAD for _ in range(32)]
            ds = [[0] * OUT_PAD for _ in range(32)]
            for r in range(32):  # one row's chunk a load, lane = position (kBatch rows at a time)
                for lane in range(32):
                    t = c0 + lane
                    live = r < nr and t < min(k, ndigits)
                    xs[r][lane] = load(row0 + r, t) if live else 0
                    if err is not None:
                        ds[r][lane] = err(row0 + r, t) if live else 0
            for lane in range(32):  # each lane walks its own row
                for j in range(cw):
                    x = xs[lane][j] + carry[lane]
                    if err is not None:
                        e0 = ds[lane][j]
                        x += pb[0] * e0 + sum(pb[c + 1] * errs[lane][c] for c in range(3))
                        if c0 + j < 4 and lane < nr:
                            x += (msg(row0 + lane) >> (8 * (c0 + j))) & 255
                        errs[lane] = [e0] + errs[lane][:2]
                    assert x < 1 << 64
                    ds[lane][j] = x & 255
                    carry[lane] = x >> 8
            for r in range(nr):
                out[row0 + r, c0 : c0 + cw] = ds[r][:cw]
    return out


def test_k10_tiles_are_bank_conflict_free():
    """The staging tile: lanes reading position j of their rows touch 16
    distinct 8-byte bank pairs a half-warp (kPad odd); the digit tile: 32
    lanes writing byte j of their rows hit 32 distinct banks (kOutPad / 4
    odd); the shared memory fits the 48 KiB of a static allocation."""
    assert PAD % 2 == 1 and PAD >= CHUNK and OUT_PAD % 8 == 4 and OUT_PAD >= CHUNK
    assert CHUNK == 32 and 32 % BATCH == 0  # a lane a position; whole batches of a warp's rows
    for j in range(CHUNK):
        pairs = [(lane * PAD + j) % 16 for lane in range(16)]
        assert len(set(pairs)) == 16
        banks = [(lane * OUT_PAD + j) // 4 % 32 for lane in range(32)]
        assert len(set(banks)) == 32
    assert WARPS * 32 * (PAD * 8 + OUT_PAD) <= 48 * 1024


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
    flat = acc.astype(np.int64)
    got = k10_model(lambda r, t: int(flat[r, t]), acc.shape[0], acc.shape[1], nd)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(python_fold(acc, nd), want)


@pytest.mark.parametrize("rows,k,nd,bits", [
    (33, 88, 88, 47), (161, 88, 88, 62), (5, 100, 88, 40), (40, 70, 88, 47), (1, 1, 3, 40),
    (32, 65, 65, 47)])
def test_k10_model_beyond_the_jax_domain(rows, k, nd, bits):
    """int64 planes up to 2^47 (the plain version's range) and 2^62 (the
    kernel's), K past and short of ndigits (zero-extended), ragged warps
    and blocks, a chunk boundary inside the row: the model equals Python
    ints, and the plain version too within its range."""
    rng = np.random.default_rng(rows + k + bits)
    acc = rng.integers(0, 1 << bits, size=(rows, k), dtype=np.int64)
    acc[0] = (1 << bits) - 1
    want = python_fold(acc, nd)
    np.testing.assert_array_equal(k10_model(lambda r, t: int(acc[r, t]), rows, k, nd), want)
    if bits <= 47:
        got = tdg.carry_fold(torch.from_numpy(acc), nd)
        assert got.shape == (rows, nd)
        np.testing.assert_array_equal(got.numpy(), want)


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
    from c_lwe_snarks_tpu_torch.ops import digits as dg

    at = torch.from_numpy(a).to(torch.float64).transpose(1, 2)  # [B, 88, n]
    sk_t = torch.from_numpy(sk).to(torch.int64)
    planes = [dg.antidiag_sums((at @ nib.to(torch.float64)).to(torch.int64))[..., :88]
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

    lo, hi = v_lo.numpy(), v_hi.numpy()
    got = k10_model(lambda r, t: int(lo[r, t]) + 16 * int(hi[r, t]), batch, 88, 88,
                    err=lambda r, t: int(errs[r, t]), msg=lambda r: int(msgs[r]))
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
    got = k10_model(lambda r, t: int(lo[r, t]) + 16 * int(hi[r, t]), B, 88, 88,
                    err=lambda r, t: int(errs[r, t]), msg=lambda r: int(msgs[r]))
    np.testing.assert_array_equal(got, want)
