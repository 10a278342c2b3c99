"""K6, the CRT-NTT kernel (c_lwe_snarks_tpu_torch/csrc/ntt.cu), modelled on
the CPU and held against the JAX package, tolerance 0.

A CUDA kernel cannot run without a card, so ``ntt_pass`` below stands
where Pallas interpret mode stands for a TPU kernel: one K6 launch in
numpy with the kernel's own constants (read from the .cu) and arithmetic
on uint32 words held in uint64 -- the bit-reversed load into the tile,
the radix-2 stages with Shoup's multiply and the 32-bit wrap of the adds,
the Montgomery pointwise product, the four-step twiddles, the scale and
Garner's CRT.  The port's own wrappers (``ntt._k6_product``,
``ntt._k6_transform``) drive it through a stand-in for ``_build.launch``,
so their passes, strides and flags are the ones under test.  The kernel
itself is held against the plain version on a GPU in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from c_lwe_snarks_tpu.models import ssp as jssp
from c_lwe_snarks_tpu.ops import modp as jmodp
from c_lwe_snarks_tpu.ops import ntt as jntt
from c_lwe_snarks_tpu.ops import sampling as jsam
from c_lwe_snarks_tpu.utils import params as jparams
from c_lwe_snarks_tpu_torch.models import snark as tsnark
from c_lwe_snarks_tpu_torch.models import ssp as tssp
from c_lwe_snarks_tpu_torch.ops import _build, ntt
from c_lwe_snarks_tpu_torch.ops import sampling as tsam
from c_lwe_snarks_tpu_torch.utils.params import Params

torch.set_num_threads(1)

P = (1 << 32) - 5
M32 = np.uint64(0xFFFFFFFF)
SOURCE = (pathlib.Path(ntt.__file__).resolve().parent.parent / "csrc" / "ntt.cu").read_text()

# module-level jits: parametrized cases of one shape share one compile
_jfwd = jax.jit(jntt.ntt_forward, static_argnums=1)
_jinv = jax.jit(jntt.ntt_inverse, static_argnums=1)
_jmul = jax.jit(jntt._poly_mul_batched)
_jsq = jax.jit(lambda a: jntt._poly_mul_batched(a, None))
_jpmul = jax.jit(jntt.poly_mul_mod_p)
_jdiv = jax.jit(jntt.poly_div_exact_mod_p, static_argnums=2)


def constant(name: str) -> int:
    """An integer constexpr of ntt.cu."""
    m = re.search(rf"constexpr \w+ {name} = (\d+)u?;", SOURCE)
    assert m, name
    return int(m.group(1))


Q = [constant(f"kQ{i}") for i in (1, 2, 3)]
SMEM_N, MAX_COLS = constant("kSmemN"), constant("kMaxCols")
F = {name: constant(f"k{name}") for name in (
    "InInt64", "InProduct", "Inverse", "Twiddle", "Scale", "ScaleMont", "OutInt64", "OutCrt")}


# ---- the kernel's arithmetic on uint32 words (numpy uint64) -------------

def add_mod(a, b, q):
    s = (a + b) & M32  # the 32-bit sum wraps for q3
    return np.where((s < a) | (s >= q), (s - q) & M32, s)


def sub_mod(a, b, q):
    return np.where(a >= b, a - b, (a - b + q) & M32)


def mul_shoup(x, w, wp, q):
    qhat = (x * wp) >> np.uint64(32)
    r = x * w - qhat * q  # in [0, 2q)
    return np.where(r >= q, r - q, r)


def shoup(w, q):
    return (np.uint64(w) << np.uint64(32)) // np.uint64(q)


def mont_mul(a, b, q):
    qinv_neg = np.uint64((-pow(q, -1, 1 << 32)) % (1 << 32))
    q = np.uint64(q)
    t = a * b
    u = (t + ((t & M32) * qinv_neg & M32) * q) >> np.uint64(32)  # < 2q
    return np.where(u >= q, u - q, u)


def crt_mod_p(r1, r2, r3):
    q1, q2, q3 = (np.uint64(q) for q in Q)
    c2 = pow(Q[0], -1, Q[1])
    c3 = pow(Q[0] * Q[1] % Q[2], -1, Q[2])
    r1q2 = np.where(r1 >= q2, r1 - q2, r1)
    t2 = mul_shoup(sub_mod(r2, r1q2, q2), np.uint64(c2), shoup(c2, Q[1]), q2)
    u = sub_mod(sub_mod(r3, r1, q3), mul_shoup(t2, q1, shoup(Q[0], Q[2]), q3), q3)
    t3 = mul_shoup(u, np.uint64(c3), shoup(c3, Q[2]), q3)
    k12 = Q[0] * Q[1] % P
    x = (r1 + mul_shoup(t2, q1, shoup(Q[0], P), np.uint64(P))
         + mul_shoup(t3, np.uint64(k12), shoup(k12, P), np.uint64(P)))
    for _ in range(2):
        x = np.where(x >= P, x - np.uint64(P), x)
    return x


def ntt_pass(inp, in2, out, table, rows, rows_a, len_a, len_b, in_pstride, out_pstride, n, L,
             istride, tstride, flags, p0, np_):
    """One K6 launch (``cls_ntt_pass``) on CPU tensors: every transform's
    residues are read before any is written, as each CUDA block of the
    kernel reads its own before writing them back."""
    assert L <= min(n, SMEM_N) and (flags & F["OutCrt"] == 0 or (p0, np_) == (0, 3))
    T = n // L
    t, i = np.arange(T)[:, None], np.arange(L)[None, :]
    e = t * tstride + i * istride  # [T, L] offsets in a row
    tab = table.numpy().view(np.uint32).astype(np.uint64).reshape(3, 2 * n + 4)
    qs = [np.uint64(Q[p0 + pl]) for pl in range(np_)]
    x = np.empty((np_, rows, T, L), np.uint64)

    def words(tensor):
        a = tensor.numpy().reshape(-1)
        return a.view(np.uint32).astype(np.uint64) if a.dtype == np.int32 else a

    for pl, q in enumerate(qs):
        for r in range(rows):
            if flags & F["InInt64"]:
                src, rr, ln = (inp, r, len_a) if r < rows_a else (in2, r - rows_a, len_b)
                flat = src.numpy().reshape(-1)
                v = flat[pl * in_pstride + rr * ln + np.minimum(e, ln - 1)].astype(np.uint64) & M32
                v = np.where(e < ln, v, np.uint64(0))
                for _ in range(2):
                    v = np.where(v >= q, v - q, v)
            else:
                off = pl * in_pstride + r * n + e
                v = words(inp)[off]
                if flags & F["InProduct"]:
                    v = mont_mul(v, words(in2)[off], int(q))
            x[pl, r] = v
    log_l = L.bit_length() - 1
    rev = np.array([int(format(k, f"0{log_l}b")[::-1], 2) if log_l else 0 for k in range(L)])
    y = np.empty_like(x)
    y[..., rev] = x  # element i lands at bit-reversed position
    inverse = bool(flags & F["Inverse"])
    for st in range(1, log_l + 1):
        half = 1 << (st - 1)
        v = y.reshape(np_, rows, T, L // (2 * half), 2, half)
        ew = np.arange(half) * (n >> st)
        if inverse:
            ew = np.where(ew > 0, n - ew, 0)
        for pl, q in enumerate(qs):
            u, w = v[pl, ..., 0, :], v[pl, ..., 1, :]
            wv = mul_shoup(w, tab[p0 + pl][ew], tab[p0 + pl][n + ew], q)
            v[pl, ..., 0, :], v[pl, ..., 1, :] = add_mod(u, wv, q), sub_mod(u, wv, q)
        y = v.reshape(np_, rows, T, L)
    for pl, q in enumerate(qs):
        tb = tab[p0 + pl]
        if flags & F["Twiddle"]:
            et = t * i  # < n
            if inverse:
                et = np.where(et > 0, n - et, 0)
            y[pl] = mul_shoup(y[pl], tb[et], tb[n + et], q)
        if flags & (F["Scale"] | F["ScaleMont"]):
            s = 2 * n + (2 if flags & F["ScaleMont"] else 0)
            y[pl] = mul_shoup(y[pl], tb[s], tb[s + 1], q)
    o = out.numpy().reshape(-1)
    if flags & F["OutCrt"]:
        for r in range(rows):
            o[r * n + e] = crt_mod_p(y[0, r], y[1, r], y[2, r]).astype(np.int64)
        return
    for pl in range(np_):
        for r in range(rows):
            off = pl * out_pstride + r * n + e
            if flags & F["OutInt64"]:
                o[off] = y[pl, r].astype(np.int64)
            else:
                o.view(np.uint32)[off] = y[pl, r].astype(np.uint32)


@pytest.fixture
def k6(monkeypatch):
    """K6 launches run ``ntt_pass``; products of the polynomial engine go
    through the kernel's wrapper on CPU tensors."""
    def launch(name, *args):
        assert name == "cls_ntt_pass" and len(args) == len(_build.SIGNATURES[name]), name
        ntt_pass(*args)

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(ntt, "_poly_mul_cyclic",
                        lambda a, b, n=None: ntt._k6_product(a, b, a.shape[-1] if n is None else n))


def _rand(rng, shape, hi=P):
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(np.int64)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64))


def test_k6_constants_match_the_port():
    """The .cu's primes, flags and one-pass limit are the wrapper's, and its
    tables hold w^e, Shoup's companions and the two scales."""
    assert tuple(Q) == ntt.NTT_PRIMES and SMEM_N == ntt.SMEM_N
    assert (F["InInt64"], F["InProduct"], F["Inverse"], F["Twiddle"]) == (
        ntt._IN_INT64, ntt._IN_PRODUCT, ntt._INVERSE, ntt._TWIDDLE)
    assert (F["Scale"], F["ScaleMont"], F["OutInt64"], F["OutCrt"]) == (
        ntt._SCALE, ntt._SCALE_MONT, ntt._OUT_INT64, ntt._OUT_CRT)
    n = 16
    tab = ntt._k6_table_np(n).astype(np.uint64)
    for pi, q in enumerate(Q):
        w = pow(ntt._generator(q), (q - 1) // n, q)
        assert pow(w, n // 2, q) == q - 1
        want = [pow(w, e, q) for e in range(n)]
        want += [pow(n, -1, q), pow(n, -1, q) * (1 << 32) % q]
        got = [int(v) for v in tab[pi, :n]] + [int(tab[pi, 2 * n]), int(tab[pi, 2 * n + 2])]
        assert got == want
        comp = list(tab[pi, n : 2 * n]) + [tab[pi, 2 * n + 1], tab[pi, 2 * n + 3]]
        assert [int(c) for c in comp] == [(v << 32) // q for v in want]


@pytest.mark.parametrize("n", [4, 1 << 11, 1 << 12, 1 << 14])
def test_k6_product_decomposition(k6, n):
    """Two launches up to the one-pass limit, four (two four-step passes a
    transform) above it; the product and the square equal JAX's
    prime-batched product and the plain version.  Every entry of the second
    factor is p - 1, so the residue adds wrap 32 bits mod q3."""
    rng = np.random.default_rng(n)
    a = _rand(rng, n // 2 + 1)
    b = np.full(n // 2 - 1, P - 1, np.int64)
    ap, bp = np.pad(a, (0, n - a.size)), np.pad(b, (0, n - b.size))
    want = np.asarray(_jmul(jnp.asarray(ap.astype(np.uint32)), jnp.asarray(bp.astype(np.uint32))))
    before = ntt.LAUNCHES["ntt"]
    got = ntt._k6_product(torch.from_numpy(a), torch.from_numpy(b), n)
    assert ntt.LAUNCHES["ntt"] - before == (2 if n <= SMEM_N else 4)
    _eq(got, want)
    _eq(got, ntt._poly_mul_plain(torch.from_numpy(ap), torch.from_numpy(bp)))
    sq = ntt._k6_product(torch.from_numpy(a), None, n)
    _eq(sq, np.asarray(_jsq(jnp.asarray(ap.astype(np.uint32)))))


def test_k6_batched_product(k6):
    """Leading axes broadcast; each row is its own product."""
    rng = np.random.default_rng(9)
    a, b = _rand(rng, (3, 1, 10)), _rand(rng, (3, 2, 20))
    got = ntt._k6_product(torch.from_numpy(a), torch.from_numpy(b), 32)
    want = ntt._poly_mul_plain(torch.from_numpy(np.pad(a, ((0, 0), (0, 0), (0, 22)))),
                               torch.from_numpy(np.pad(b, ((0, 0), (0, 0), (0, 12)))))
    _eq(got, want)


@pytest.mark.parametrize("impl", ["plain", "k6"])
@pytest.mark.parametrize("q", ntt.NTT_PRIMES)
@pytest.mark.parametrize("n", [2, 16, 256])
def test_ntt_forward_inverse(request, impl, q, n):
    """The public one-prime transforms equal JAX's, natural order, inverse
    scaled by n^-1; inputs at q - 1 included (q3 > 2^31: its adds wrap)."""
    if impl == "k6":
        request.getfixturevalue("k6")
    rng = np.random.default_rng(n + q)
    x = _rand(rng, (2, n), q)
    x[0, -1] = x[1, 0] = q - 1
    x[1, n // 2 :] = q - 1
    xu = jnp.asarray(x.astype(np.uint32))
    transform = ntt._k6_transform if impl == "k6" else ntt._transform
    p0 = ntt.NTT_PRIMES.index(q)
    fwd = transform(torch.from_numpy(x)[None], False, p0)[0]
    _eq(fwd, _jfwd(xu, q))
    _eq(transform(torch.from_numpy(x)[None], True, p0)[0], _jinv(xu, q))
    _eq(transform(fwd[None], True, p0)[0], x)
    if impl == "plain":
        _eq(ntt.ntt_forward(torch.from_numpy(x), q), fwd)
        _eq(ntt.ntt_inverse(fwd, q), x)


def test_k6_transform_four_step(k6):
    """Past the one-pass limit the public transforms reorder the four-step's
    [k1, k2] layout to natural order: equal to the plain transforms for
    all three primes at once and for one."""
    n = 2 * SMEM_N
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.stack([_rand(rng, (2, n), q) for q in Q]))
    x[:, :, -1] = torch.tensor(Q).reshape(3, 1) - 1
    for inverse in (False, True):
        want = ntt._transform(x, inverse)
        _eq(ntt._k6_transform(x, inverse), want)
        _eq(ntt._k6_transform(x[2:], inverse, 2), want[2:])


@pytest.mark.parametrize("impl", ["plain", "k6"])
@pytest.mark.parametrize("zero_top", [0, 3])
def test_div_exact_with_den_degree(request, impl, zero_top):
    """The division with den's degree and leading coefficient given by the
    caller (no read from the device) equals JAX's; zero_top > 0 takes the
    shift branch."""
    if impl == "k6":
        request.getfixturevalue("k6")
    rng = np.random.default_rng(20 + zero_top)
    d = 16
    t = _rand(rng, d)
    if zero_top:
        t[-zero_top:] = 0
    quot = _rand(rng, d)
    num = np.asarray(_jpmul(jnp.asarray(t.astype(np.uint32)), jnp.asarray(quot.astype(np.uint32))))
    want = _jdiv(jnp.asarray(num), jnp.asarray(t.astype(np.uint32)), d)
    tt, tn = torch.from_numpy(t), torch.from_numpy(num.astype(np.int64))
    degree, lead = ntt.poly_degree_and_lead(tt)
    assert (degree, lead) == (d - 1 - zero_top, int(t[d - 1 - zero_top]))
    assert ntt.poly_true_degree(tt) == degree
    got = ntt.poly_div_exact_mod_p(tn, tt, d, den_degree=degree, den_lead=lead)
    _eq(got, want)
    _eq(got, quot)
    _eq(ntt.poly_div_exact_mod_p(tn, tt, d), quot)


TINY = Params(d=16, m=8, n=32)
ENT_SEED = bytes(range(40))
PROVE_OFFSET = 12345 * 16


@functools.cache
def _jax_prover_polys():
    """(witness, t, v rows, delta, w, v, h) of the JAX prover at TINY: its
    prover's steps, with the product and the division through the
    module-level jits (one compile for this file)."""
    d, m = TINY.d, TINY.m
    key = jsam.PRGKey(ENT_SEED)

    @jax.jit
    def front():
        wits, inst = jssp.random_ssp(key, 0, jparams.Params(d=d, m=m, n=TINY.n))
        delta = jmodp.bytes_to_u64_mod_p(jsam.keystream_bytes(key, PROVE_OFFSET, 8))
        w = jmodp.addmod_p(jmodp.mulmod_p(delta, inst.t),
                           jmodp.gated_rowsum_mod_p(inst.v[1:], wits[: m - 1]))
        return wits, inst.t, inst.v, delta, w, jmodp.addmod_p(inst.v[0], w)

    wits, t, v_rows, delta, w, v = front()
    v_sq = _jpmul(v, v)
    num = v_sq.at[0].set(jmodp.submod_p(v_sq[0], jnp.uint32(1)))
    h = _jdiv(num, t, d)
    return tuple(np.array(x) for x in (wits, t, v_rows, delta, w, v, h))


@pytest.mark.parametrize("impl", ["plain", "k6"])
def test_prover_polys_matches_jax(request, impl):
    """(delta, w, v, h) of the port's prover equal the JAX prover's at the
    tiny profile, from the same SSP, witness and entropy offset."""
    if impl == "k6":
        request.getfixturevalue("k6")
    wits, t, v_rows, *want = _jax_prover_polys()
    ssp = tssp.SSP(t=torch.from_numpy(t.astype(np.int64)), v=torch.from_numpy(v_rows.astype(np.int64)))
    got = tsnark.prover_polys(tsam.PRGKey(ENT_SEED, "cpu"), PROVE_OFFSET, ssp,
                              torch.from_numpy(wits), TINY)
    for g, w in zip(got, want):
        _eq(g, w)
