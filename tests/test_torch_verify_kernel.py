"""K11 (c_lwe_snarks_tpu_torch/csrc/verify.cu), the verifier's decrypts and
checks, on the CPU: its plain versions against the JAX package's own
``verifier``, ``decrypt`` and ``test_error_ok`` (through ``bigint_dot`` and
``digits_ge``), and a numpy model of the kernel's split held against them.

A CUDA kernel cannot run without a card, so the model stands where Pallas
interpret mode stands for the TPU kernels.  It follows the .cu with its
own constants: per-slice uint32 planes of kSliceRows rows (each digit
pair (q, 87 - q) a thread, kGroups row groups, a digit a walk of __dp4a
over a's words and funnel-shifted windows of sk's reversed, zero-padded
row, the products at digit 88 and above never formed), the last block's
combine adding the slices in a fixed order,
the fold truncated at digit 88, each side taken mod p in 16 lanes, the
threshold count compared digit by digit from the top; the at-s blocks'
sums over kAtSCols columns with the power walk; and the last block's
relations.  Every bound the .cu states is asserted.  Tolerance 0: both
sides are exact integers.  The kernel itself is held against the plain
versions on a GPU in tests/test_torch_cuda.py and chip_smoke.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.models import lwe as jlwe
from c_lwe_snarks_tpu.models import snark as jsnark
from c_lwe_snarks_tpu.models import ssp as jssp
from c_lwe_snarks_tpu.ops import digits as jdg
from c_lwe_snarks_tpu.ops import modp as jmodp
from c_lwe_snarks_tpu.utils import params as jparams
from c_lwe_snarks_tpu_torch.__main__ import run_protocol
from c_lwe_snarks_tpu_torch.models import lwe as tlwe
from c_lwe_snarks_tpu_torch.models import snark as tsnark
from c_lwe_snarks_tpu_torch.ops import verify
from c_lwe_snarks_tpu_torch.utils.params import Params

torch.set_num_threads(1)

P = Params(d=16, m=8, n=32)
JP = jparams.custom(d=16, m=8, n=32)
CRS_SEED, ENT_SEED = bytes(range(40, 80)), bytes(range(40))
PRIME = (1 << 32) - 5
FIELDS = ("h", "hat_h", "hat_v", "v_w", "b_w")
SOURCE = (pathlib.Path(verify.__file__).resolve().parent.parent / "csrc" / "verify.cu").read_text()


def constant(name: str) -> int:
    """An integer constexpr of verify.cu (a literal)."""
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


DIGITS, GROUPS, SLICE_ROWS, ROW_BYTES, AT_S_COLS, THRESHOLDS = (
    constant(n) for n in ("kDigits", "kGroups", "kSliceRows", "kRowBytes", "kAtSCols",
                          "kThresholds"))
PAIRS = DIGITS // 2
THREADS = PAIRS * GROUPS
LANES, PER = 16, 6  # carry.cuh: a row over 16 lanes, six positions a lane


def test_wrapper_constants_are_the_kernels():
    assert (verify.SLICE_ROWS, verify.AT_S_COLS, verify.THRESHOLDS) == (
        SLICE_ROWS, AT_S_COLS, THRESHOLDS)
    assert "kThreads = kPairs * kGroups" in SOURCE and THREADS % 32 == 0


# ---- the JAX package's side --------------------------------------------------


def _jax_dev(run, proof_np=None, alpha=None):
    """The port's artifacts as the JAX package's dataclasses."""
    vrs = jsnark.VRSDev(
        alpha=jnp.uint32(int(run.vrs.alpha) if alpha is None else alpha),
        beta=jnp.uint32(int(run.vrs.beta)), s=jnp.uint32(int(run.vrs.s)),
        sk=jnp.asarray(run.vrs.sk.numpy()))
    ssp = jssp.SSPDev(t=jnp.asarray(run.ssp.t.numpy()), v=jnp.asarray(run.ssp.v.numpy()))
    cts = run.proof.stack().numpy() if proof_np is None else proof_np
    proof = jsnark.ProofDev(*(jnp.asarray(c) for c in cts))
    return vrs, ssp, proof


@jax.jit
def _jax_verify(vrs, ssp, proof):
    """The JAX package's verdict, and the words K11 returns beside it: the
    five decrypts, t(s), v_0(s) and the threshold count of b_w's dot."""
    dec = jlwe.decrypt(proof.stack(), vrs.sk, JP)
    t_s = jmodp.poly_eval_mod_p(ssp.t, vrs.s)
    v0_s = jmodp.poly_eval_mod_p(ssp.v[0], vrs.s)
    count = _jax_count(proof.b_w[:-1], vrs.sk)
    words = jnp.concatenate([dec, jnp.stack([t_s, v0_s, count.astype(jnp.uint32)])])
    return (jsnark.verifier(vrs, ssp, proof, JP), jsnark.test_error_ok(vrs, proof, JP), words)


def _jax_count(a, sk):
    """test_error_ok's quotient limb count: thresholds p * 2^(64j) <= dot."""
    dot = jdg.bigint_dot(a, sk)
    thr = jnp.asarray(np.asarray(jsnark._test_error_thresholds(), np.uint8))
    return jnp.sum(jdg.digits_ge(dot[None, :], thr).astype(jnp.int32))


_jax_count_jit = jax.jit(_jax_count)
_jax_decrypt = jax.jit(lambda ct, sk: jlwe.decrypt(ct, sk, JP))


@pytest.fixture(scope="module")
def port_run():
    return run_protocol(P, "cpu", CRS_SEED, ENT_SEED)


# ---- the model of the kernel ------------------------------------------------


def fold35(x):
    return 5 * (x >> 32) + (x & 0xFFFFFFFF)


def reduce53(x: int) -> int:
    """modp.cuh's reduce53_mod_p: x < 2^53, two conditional subtractions."""
    assert 0 <= x < 1 << 53
    r = fold35(x)
    for _ in range(2):
        if r >= PRIME:
            r -= PRIME
    assert r < PRIME
    return r


def anti_diagonals(outer: np.ndarray) -> np.ndarray:
    """P[t] = sum_{x + y = t} outer[x, y] for t < 88 (the planes at digit 88
    and above are never formed)."""
    flipped = np.fliplr(outer)
    return np.array([np.trace(flipped, offset=DIGITS - 1 - t) for t in range(DIGITS)],
                    dtype=np.uint64)


def staged_words(a: np.ndarray, sk: np.ndarray) -> tuple:
    """Rows as a block stages them: a's bytes and sk's reversed (kr[j] =
    sk[87 - j]), each zero-padded to kRowBytes, read as LE words [rows, 24]."""
    ab = np.zeros((a.shape[0], ROW_BYTES), np.uint8)
    kb = np.zeros((a.shape[0], ROW_BYTES), np.uint8)
    ab[:, :DIGITS] = a
    kb[:, :DIGITS] = sk[:, ::-1]
    kw = kb.view("<u4")
    # the .cu stages sk a word a load: its word j byte-swapped at word 21 - j
    sk_words = np.ascontiguousarray(sk).view("<u4")
    np.testing.assert_array_equal(kw[:, : DIGITS // 4], sk_words[:, ::-1].byteswap())
    return ab.view("<u4").astype(np.uint64), kw.astype(np.uint64)


def dp4a(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return sum(((x >> np.uint64(8 * j)) & np.uint64(255)) * ((y >> np.uint64(8 * j)) & np.uint64(255))
               for j in range(4))


def digit_dot_model(aw: np.ndarray, kw: np.ndarray, t: int) -> np.ndarray:
    """verify.cu's digit_dot for every row: a's words 0 .. t / 4 against
    windows of the reversed row from byte 87 - t, two aligned words
    funnel-shifted right by 8 (o & 3) bits."""
    o = DIGITS - 1 - t
    base, sh = o >> 2, np.uint64(8 * (o & 3))
    assert base + (t >> 2) + 1 < ROW_BYTES // 4  # the last window word lies in the row
    s = np.zeros(aw.shape[0], np.uint64)
    k0 = kw[:, base]
    for i in range((t >> 2) + 1):
        k1 = kw[:, base + i + 1]
        window = ((k1 << np.uint64(32) | k0) >> sh) & np.uint64(0xFFFFFFFF)
        s += dp4a(aw[:, i], window)
        k0 = k1
    return s


def slice_planes_model(a: np.ndarray, sk: np.ndarray) -> np.ndarray:
    """part [S, 88] of one ciphertext: slice sl's rows [R sl, R sl + R) (R =
    kSliceRows), row group g its rows R sl + g, + 8, ...; thread (q, g) sums digits q
    and 87 - q of its rows (digit_dot) in uint32; the groups' sums added in
    uint32.  Each slice's planes are held against the anti-diagonal sums of
    its byte products."""
    n = a.shape[0]
    owners = sorted([q for q in range(PAIRS)] + [DIGITS - 1 - q for q in range(PAIRS)])
    assert owners == list(range(DIGITS))  # each digit has exactly one thread
    aw, kw = staged_words(a, sk)
    per_row = np.stack([digit_dot_model(aw, kw, t) for t in range(DIGITS)], axis=1)
    slices = -(-n // SLICE_ROWS)
    red = np.zeros((slices, GROUPS, DIGITS), np.uint64)
    rows = np.arange(n)
    np.add.at(red, (rows // SLICE_ROWS, rows % SLICE_ROWS % GROUPS), per_row)
    assert red.max() < 1 << 32  # s_lo, s_hi: uint32
    part = red.sum(1)
    assert part.max() < 1 << 32  # the slice's planes: uint32
    for sl in range(slices):
        lo, hi = sl * SLICE_ROWS, min(n, (sl + 1) * SLICE_ROWS)
        outer = np.einsum("rx,ry->xy", a[lo:hi].astype(np.uint64), sk[lo:hi].astype(np.uint64))
        np.testing.assert_array_equal(part[sl], anti_diagonals(outer))
    return part


def combine_model(part: np.ndarray, b: np.ndarray, count: bool):
    """The last block's combine: (dec, dot digits, threshold count)."""
    planes = [0] * DIGITS
    for row in part:  # slice order, 64-bit
        planes = [x + int(y) for x, y in zip(planes, row)]
        assert max(planes) < 1 << 63
    value = sum(x << (8 * t) for t, x in enumerate(planes))
    pos96 = (value % (1 << (8 * LANES * PER))).to_bytes(LANES * PER, "little")
    dig = list(pos96[:DIGITS])  # the digits at 88 and above and the carry out dropped
    w = [pow(256, t, PRIME) for t in range(DIGITS)]
    acc_d = acc_b = 0
    for g in range(LANES):
        lane_d = sum(dig[t] * w[t] for t in range(PER * g, min(PER * g + PER, DIGITS)))
        lane_b = sum(int(b[t]) * w[t] for t in range(PER * g, min(PER * g + PER, DIGITS)))
        assert lane_d < 1 << 43 and lane_b < 1 << 43
        acc_d, acc_b = acc_d + lane_d, acc_b + lane_b
    md, mb = reduce53(acc_d), reduce53(acc_b)
    dec = mb - md if mb >= md else mb + (PRIME - md)
    n_ge = None
    if count:
        n_ge = 0
        for j in range(THRESHOLDS):
            thr = [0xFB if t == 8 * j else 0xFF if 8 * j < t < 8 * j + 4 else 0
                   for t in range(DIGITS)]
            ge = True
            for t in range(DIGITS - 1, -1, -1):
                if dig[t] != thr[t]:
                    ge = dig[t] > thr[t]
                    break
            n_ge += ge
    return dec, np.array(dig, np.uint8), n_ge


def at_s_model(row: np.ndarray, s: int) -> int:
    """The at-s blocks' residues added in order: block i sums its columns'
    fold35(t[c] s^c) a thread (stride THREADS), folds, adds the block."""
    d = row.shape[0]
    pw = [1] * d
    for c in range(1, d):
        pw[c] = pw[c - 1] * s % PRIME
    total = 0
    for c0 in range(0, d, AT_S_COLS):
        cols = np.arange(c0, min(d, c0 + AT_S_COLS))
        prods = fold35(row[cols].astype(np.uint64) * np.array(pw[c0 : c0 + len(cols)], np.uint64))
        per_thread = np.zeros(THREADS, np.uint64)
        np.add.at(per_thread, (cols - c0) % THREADS, prods)
        assert int(per_thread.max()) < 1 << 40
        block = int(fold35(per_thread).sum())
        assert block < 1 << 45
        total += reduce53(block)
    return reduce53(total)


def finish_model(words, alpha: int, beta: int, limb_bound: int) -> bool:
    """The last block's relations on its thread, in uint32 mod-p steps."""
    h, hat_h, hat_v, w_s, b_s, t_s, v0_s, count = (int(x) for x in words)
    sub = lambda a, b: a - b if a >= b else a + (PRIME - b)
    v_s = (v0_s + w_s) % PRIME
    return (h * alpha % PRIME == hat_h and v_s * alpha % PRIME == hat_v
            and sub(sub(v_s * v_s % PRIME, 1), h * t_s % PRIME) == 0
            and w_s * beta % PRIME == b_s and -count < limb_bound)


def kernel_model(cts: np.ndarray, sk: np.ndarray, t: np.ndarray, v0: np.ndarray, s: int):
    """words int64 [8] as verify_kernel writes them."""
    words = []
    for c in range(5):
        dec, _, n_ge = combine_model(slice_planes_model(cts[c, :-1], sk), cts[c, -1], c == 4)
        words.append(dec)
    return np.array(words + [at_s_model(t, s), at_s_model(v0, s), n_ge], np.int64)


# ---- the verifier: plain version, model and the JAX package --------------------


def _check_all(run, cts_np, alpha=None):
    """Port plain, the kernel's model and the JAX package agree on the
    verdict and the words; returns the verdict."""
    a = int(run.vrs.alpha) if alpha is None else alpha
    vrs = tsnark.VRS(alpha=torch.tensor(a, dtype=torch.uint32), beta=run.vrs.beta, s=run.vrs.s,
                     sk=run.vrs.sk)
    cts = torch.from_numpy(cts_np)
    proof = tsnark.Proof(*cts.unbind())
    want_ok, want_err, want_words = _jax_verify(*_jax_dev(run, cts_np, alpha))
    ok, words = verify.verify(tuple(cts.unbind()), vrs.sk, run.ssp.t, run.ssp.v[0], vrs.s,
                              vrs.alpha, vrs.beta, P.log_smudging // 8)
    assert ok.dtype == torch.bool and words.dtype == torch.int64
    np.testing.assert_array_equal(words.numpy(), np.asarray(want_words).astype(np.int64))
    assert bool(ok) == bool(want_ok) == bool(tsnark.verifier(vrs, run.ssp, proof, P))
    assert bool(tsnark.test_error_ok(vrs, proof, P)) == bool(want_err)
    model = kernel_model(cts_np, vrs.sk.numpy(), run.ssp.t.numpy(), run.ssp.v[0].numpy(),
                         int(vrs.s))
    np.testing.assert_array_equal(model, words.numpy())
    assert finish_model(model, a, int(vrs.beta), P.log_smudging // 8) == bool(want_ok)
    return bool(want_ok)


def test_honest_proof_accepted(port_run):
    assert _check_all(port_run, port_run.proof.stack().numpy().copy())


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("where", ["b", "a"])
def test_tampered_field_rejected(port_run, field, where):
    """One bit of one field's b row, or of one of its a rows, flipped."""
    cts = port_run.proof.stack().numpy().copy()
    row = P.n if where == "b" else 7
    cts[FIELDS.index(field), row, 3] ^= 1
    assert not _check_all(port_run, cts)


def test_wrong_alpha_rejected(port_run):
    assert not _check_all(port_run, port_run.proof.stack().numpy().copy(),
                          alpha=(int(port_run.vrs.alpha) + 1) % PRIME)


@pytest.mark.parametrize("name", ["t", "v0", "s", "alpha", "beta"])
def test_verify_refuses_int64_words(port_run, name):
    """The VRS's scalars and the SSP's rows are uint32 on every device: an
    int64 one is a ValueError on the CPU as on the card."""
    vrs, ssp = port_run.vrs, port_run.ssp
    args = {"t": ssp.t, "v0": ssp.v[0], "s": vrs.s, "alpha": vrs.alpha, "beta": vrs.beta}
    ok, _ = verify.verify(tuple(port_run.proof.stack().unbind()), vrs.sk, **args,
                          limb_bound=P.log_smudging // 8)
    assert bool(ok)
    args[name] = args[name].to(torch.int64)
    with pytest.raises(ValueError, match=f"{name}:"):
        verify.verify(tuple(port_run.proof.stack().unbind()), vrs.sk, **args,
                      limb_bound=P.log_smudging // 8)


# ---- decrypts --------------------------------------------------------------------


def _decrypt_case(rng, k: int, n: int, b_small: bool = False):
    ct = rng.integers(0, 256, size=(k, n + 1, 88), dtype=np.uint8)
    sk = rng.integers(0, 256, size=(n, 88), dtype=np.uint8)
    if b_small:
        ct[:, n, 1:] = 0  # b < 256 <= <a, sk> mod 2^704
    return ct, sk


def _to_int(row) -> int:
    return int.from_bytes(np.asarray(row, np.uint8).tobytes(), "little")


def test_decrypt_b_below_dot():
    """b < <a, sk> mod 2^704 (as after a negative smudge): each side is
    taken mod p on its own, as the JAX package does; subtracting the
    digits mod 2^704 first would give another value."""
    rng = np.random.default_rng(14)
    ct, sk = _decrypt_case(rng, 3, P.n, b_small=True)
    want = np.asarray(_jax_decrypt(jnp.asarray(ct), jnp.asarray(sk))).astype(np.int64)
    got = verify.decrypt(torch.from_numpy(ct), torch.from_numpy(sk))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tlwe.decrypt(torch.from_numpy(ct), torch.from_numpy(sk), P).numpy(),
                                  want)
    for c in range(3):
        dot = sum(_to_int(ct[c, r]) * _to_int(sk[r]) for r in range(P.n)) % (1 << 704)
        b = _to_int(ct[c, P.n])
        assert b < dot
        assert want[c] == (b % PRIME - dot % PRIME) % PRIME
        assert want[c] != ((b - dot) % (1 << 704)) % PRIME
        model, _, _ = combine_model(slice_planes_model(ct[c, :-1], sk), ct[c, -1], False)
        assert model == want[c]


@pytest.mark.parametrize("k", [1, 5, 7])
def test_batched_decrypts(k):
    """k ciphertexts in one call, as the probes decrypt them."""
    rng = np.random.default_rng(k)
    ct, sk = _decrypt_case(rng, k, P.n)
    ct[0, P.n, 1:] = 0  # one of them with b < <a, sk>
    want = np.asarray(_jax_decrypt(jnp.asarray(ct), jnp.asarray(sk))).astype(np.int64)
    got = verify.decrypt(torch.from_numpy(ct), torch.from_numpy(sk))
    assert got.shape == (k,) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    model = [combine_model(slice_planes_model(ct[c, :-1], sk), ct[c, -1], False)[0]
             for c in range(k)]
    np.testing.assert_array_equal(np.array(model, np.int64), want)


# ---- the threshold count --------------------------------------------------------


@pytest.mark.parametrize("delta", [0, -1], ids=["equal", "one_less"])
@pytest.mark.parametrize("j", range(THRESHOLDS))
def test_threshold_edges(j, delta):
    """A dot equal to p * 2^(64j), and one less: equal counts as >=, as in
    the JAX package's digits_ge."""
    target = (PRIME << (64 * j)) + delta
    n = 3
    a = np.zeros((n, 88), np.uint8)
    sk = np.zeros((n, 88), np.uint8)
    a[0] = np.frombuffer(target.to_bytes(88, "little"), np.uint8)
    sk[0, 0] = 1  # <a, sk> = target
    b_w = np.concatenate([a, np.zeros((1, 88), np.uint8)])
    want = int(_jax_count_jit(jnp.asarray(a), jnp.asarray(sk)))
    assert want == j + (delta == 0)  # p * 2^(64i) <= target for i < j, and i = j iff equal
    got = verify.error_count_plain(torch.from_numpy(b_w), torch.from_numpy(sk))
    assert int(got) == want
    _, dig, n_ge = combine_model(slice_planes_model(a, sk), b_w[-1], True)
    assert _to_int(dig) == target and n_ge == want


# ---- the split at the release width ---------------------------------------------


@pytest.mark.parametrize("n,fill", [(1, "random"), (32, "max"), (33, "random"), (200, "max"),
                                    (1470, "random")])
def test_split_model_matches_bigint_dot(n, fill):
    """The slices' planes added in order and folded equal bigint_dot (JAX),
    at a ragged last slice, one row, the release n and with every byte 255
    (the planes at their bound)."""
    rng = np.random.default_rng(n)
    ct, sk = _decrypt_case(rng, 1, n)
    if fill == "max":
        ct[:] = 255
        sk[:] = 255
    part = slice_planes_model(ct[0, :-1], sk)
    assert part.shape == (-(-n // SLICE_ROWS), DIGITS)
    dec, dig, _ = combine_model(part, ct[0, -1], False)
    want_dot = np.asarray(jax.jit(jdg.bigint_dot)(jnp.asarray(ct[0, :-1]), jnp.asarray(sk)))
    np.testing.assert_array_equal(dig, want_dot)
    want = np.asarray(jax.jit(lambda c, s: jlwe.decrypt(c, s, JP))(jnp.asarray(ct), jnp.asarray(sk)))
    assert dec == int(want[0])


@pytest.mark.parametrize("s", [0, 1, PRIME - 1, 3141592653])
def test_at_s_model_matches_poly_eval(s):
    """The at-s blocks at d = 2^15 (16 blocks) and at a ragged d, every
    coefficient p - 1 in one row, against the JAX package's poly_eval_mod_p."""
    rng = np.random.default_rng(s % 1000)
    for d in (1 << 15, 3000):
        row = rng.integers(0, PRIME, size=d, dtype=np.uint64).astype(np.uint32)
        for coeffs in (row, np.full(d, PRIME - 1, np.uint32)):
            want = int(jax.jit(jmodp.poly_eval_mod_p)(jnp.asarray(coeffs), jnp.uint32(s)))
            assert at_s_model(coeffs, s) == want
