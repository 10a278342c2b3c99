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
from c_lwe_snarks_tpu_torch.ops import _build, modp, ntt
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
SMEM_N, NEWTON_MAX_N = constant("kSmemN"), constant("kNewtonMaxN")
F = {name: constant(f"k{name}") for name in (
    "InInt64", "InProduct", "Inverse", "Twiddle", "Scale", "ScaleMont", "OutInt64", "OutCrt",
    "TwoMinus")}
R_ = {name: constant(f"kRow{name}") for name in ("Square", "StoreB", "BHat")}


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


def twiddle(tm, h, j, inverse):
    """w_2h^(+-j) * 2^32 from the stage table (tm[h + j] = w_2h^j * 2^32 mod
    q): w_2h^-j = -w_2h^(h - j), j > 0."""
    j = np.asarray(j)
    neg = np.full(j.shape, bool(inverse)) & (j != 0)
    return tm[h + np.where(neg, h - j, j)], neg


def bf_dif(u, v, w, neg, q):
    d = np.where(neg, sub_mod(v, u, q), sub_mod(u, v, q))
    return add_mod(u, v, q), mont_mul(d, w, int(q))


def bf_dit(u, v, w, neg, q):
    t = mont_mul(v, w, int(q))
    a, b = add_mod(u, t, q), sub_mod(u, t, q)
    return np.where(neg, b, a), np.where(neg, a, b)


def stages(x, log_l, tm, inverse, q, dif):
    """The kernel's ``stages`` on x [..., L] (a copy): an odd log_l's
    radix-2 stage first, then radix-4 pairs of stages on four elements
    x[b + {0, g, 2g, 3g}]; DIF natural -> bit-reversed, DIT the converse;
    twiddles from the stage table tm (at least L entries), in Montgomery
    form."""
    x = x.copy()
    half = 1 << (log_l - 1)
    todo = log_l
    if log_l & 1:
        h = half if dif else 1
        j0 = np.arange(half)
        j = j0 & (h - 1)
        i0 = 2 * (j0 - j) + j
        u, v = (bf_dif if dif else bf_dit)(x[..., i0], x[..., i0 + h],
                                            *twiddle(tm, h, j, inverse), q)
        x[..., i0], x[..., i0 + h] = u, v
        todo -= 1
    for pr in range(todo // 2):
        lg = log_l - (log_l & 1) - 2 - 2 * pr if dif else (log_l & 1) + 2 * pr
        g = 1 << lg
        r = np.arange(half // 2)
        j = r & (g - 1)
        b = 4 * (r - j) + j
        x0, x1, x2, x3 = (x[..., b + m * g] for m in range(4))
        tw = lambda h, jj: twiddle(tm, h, jj, inverse)
        if dif:
            x0, x2 = bf_dif(x0, x2, *tw(2 * g, j), q)
            x1, x3 = bf_dif(x1, x3, *tw(2 * g, j + g), q)
            x0, x1 = bf_dif(x0, x1, *tw(g, j), q)
            x2, x3 = bf_dif(x2, x3, *tw(g, j), q)
        else:
            x0, x1 = bf_dit(x0, x1, *tw(g, j), q)
            x2, x3 = bf_dit(x2, x3, *tw(g, j), q)
            x0, x2 = bf_dit(x0, x2, *tw(2 * g, j), q)
            x1, x3 = bf_dit(x1, x3, *tw(2 * g, j + g), q)
        for m, y in enumerate((x0, x1, x2, x3)):
            x[..., b + m * g] = y
    return x


def bitrev(L):
    log_l = L.bit_length() - 1
    return np.array([int(format(k, f"0{log_l}b")[::-1], 2) if log_l else 0 for k in range(L)])


def words(tensor):
    """A tensor's memory as uint32 words (int32) or int64 values, flat."""
    a = tensor.numpy().reshape(-1)
    return a.view(np.uint32).astype(np.uint64) if a.dtype == np.int32 else a


def pass_table(table, n):
    return table.numpy().view(np.uint32).astype(np.uint64).reshape(3, 3 * n + 4)


def times_root(y, tb, n, e, inverse, q):
    if inverse:
        e = np.where(e > 0, n - e, 0)
    return mul_shoup(y, tb[e], tb[n + e], q)


def ntt_pass(inp, in2, out, table, rows, rows_a, len_a, len_b, lda, ldb, in_pstride, out_pstride,
             n, L, istride, tstride, out_len, flags, p0, np_):
    """One ``cls_ntt_pass`` launch on CPU tensors: every transform's residues
    are read before any is written, as each CUDA block reads its own tile
    before writing it back; the stages are DIF with the stage twiddles
    w_L^j = w_n^(j n / L), the tile is stored from its bit-reversed order."""
    assert L <= min(n, SMEM_N) and (flags & F["OutCrt"] == 0 or (p0, np_) == (0, 3))
    T = n // L
    t, i = np.arange(T)[:, None], np.arange(L)[None, :]
    e = t * tstride + i * istride  # [T, L] offsets in a row
    tab = pass_table(table, n)
    qs = [np.uint64(Q[p0 + pl]) for pl in range(np_)]
    x = np.empty((np_, rows, T, L), np.uint64)
    for pl, q in enumerate(qs):
        for r in range(rows):
            if flags & F["InInt64"]:
                src, rr, ln, ld = (inp, r, len_a, lda) if r < rows_a else (in2, r - rows_a, len_b, ldb)
                flat = src.numpy().reshape(-1)
                v = flat[pl * in_pstride + rr * ld + np.minimum(e, ln - 1)].astype(np.uint64) & M32
                v = np.where(e < ln, v, np.uint64(0))
                for _ in range(2):
                    v = np.where(v >= q, v - q, v)
            else:
                off = pl * in_pstride + r * n + e
                v = words(inp)[off]
                if flags & F["InProduct"]:
                    v = mont_mul(v, words(in2)[off], int(q))
            x[pl, r] = v
    inverse = bool(flags & F["Inverse"])
    y = np.empty_like(x)
    for pl, q in enumerate(qs):
        y[pl] = stages(x[pl], L.bit_length() - 1, tab[p0 + pl, 2 * n :], inverse, q, dif=True)
    y = y[..., bitrev(L)]  # element i sits at the bit-reversed position
    for pl, q in enumerate(qs):
        tb = tab[p0 + pl]
        if flags & F["Twiddle"]:
            y[pl] = times_root(y[pl], tb, n, t * i, inverse, q)  # t * i < n
        if flags & (F["Scale"] | F["ScaleMont"]):
            s = 3 * n + (2 if flags & F["ScaleMont"] else 0)
            y[pl] = mul_shoup(y[pl], tb[s], tb[s + 1], q)
    o = out.numpy().reshape(-1)
    if flags & F["OutCrt"]:
        keep = e < out_len
        for r in range(rows):
            v = crt_mod_p(y[0, r], y[1, r], y[2, r])
            if flags & F["TwoMinus"]:
                v = two_minus(v, e == 0)
            o[r * out_len + e[keep]] = v[keep].astype(np.int64)
        return
    for pl in range(np_):
        for r in range(rows):
            off = pl * out_pstride + r * n + e
            if flags & F["OutInt64"]:
                o[off] = y[pl, r].astype(np.int64)
            else:
                o.view(np.uint32)[off] = y[pl, r].astype(np.uint32)


def two_minus(v, first):
    y = np.where(first, np.uint64(2), np.uint64(0)) + np.uint64(P) - v
    return np.where(y >= P, y - np.uint64(P), y)


def ntt_rows(x, bhat, table, rows, b_off, x_pstride, h_pstride, n, n1, flags):
    """One ``cls_ntt_rows`` launch: for each prime and row of the batch, the
    [n1, n2] layout's rows of both operands forward (DIF, w_n2^j = w_n^(j
    n1)), the second's stored to bhat or read from it, the Montgomery
    product, inverse rows (DIT) and w_n^(-k1 j2), over the first operand."""
    n2 = n // n1
    assert n2 >= 4 and not (flags & R_["StoreB"] and flags & (R_["BHat"] | R_["Square"]))
    tab = pass_table(table, n)
    xw = x.numpy().reshape(-1).view(np.uint32)
    hw = bhat.numpy().reshape(-1).view(np.uint32)
    k1, j2 = np.arange(n1)[:, None], np.arange(n2)[None, :]
    for pi, q in enumerate(np.uint64(v) for v in Q):
        tb, log2 = tab[pi], n2.bit_length() - 1
        fwd = lambda a: stages(a, log2, tb[2 * n :], False, q, dif=True)
        for r in range(rows):
            sa = slice(pi * x_pstride + r * n, pi * x_pstride + (r + 1) * n)
            sh = slice(pi * h_pstride + r * n, pi * h_pstride + (r + 1) * n)
            a = fwd(xw[sa].astype(np.uint64).reshape(n1, n2))
            if flags & R_["Square"]:
                b = a
            elif flags & R_["BHat"]:
                b = hw[sh].astype(np.uint64).reshape(n1, n2)
            else:
                sb = slice(sa.start + b_off * n, sa.stop + b_off * n)
                b = fwd(xw[sb].astype(np.uint64).reshape(n1, n2))
                if flags & R_["StoreB"]:
                    hw[sh] = b.reshape(-1).astype(np.uint32)
            y = stages(mont_mul(a, b, int(q)), log2, tb[2 * n :], True, q, dif=False)
            xw[sa] = times_root(y, tb, n, k1 * j2, True, q).reshape(-1).astype(np.uint32)


def ntt_newton(t, seeds, out, table, rows, lt, ldt, levels, N, seed, seed_tensor):
    """One ``cls_ntt_newton`` launch: a cluster of three CTAs a row, each
    with its own shared arrays (S, X, P here: one array a rank); rank j
    computes mod prime j, and the CRT after each inverse is split by rank
    into thirds, each rank reading the other ranks' X (distributed shared
    memory) and writing every rank's P."""
    assert 4 <= N <= NEWTON_MAX_N and (levels == 1 or 1 << (levels + 1) <= N)
    logN = N.bit_length() - 1
    tab = table.numpy().view(np.uint32).astype(np.uint64).reshape(3, N + 2 * (logN + 1))
    tv, sv, o = t.numpy().reshape(-1), seeds.numpy().reshape(-1), out.numpy().reshape(-1)
    qs = [np.uint64(q) for q in Q]

    def product(pi, n, s_hat, x_in):
        """X = DIT^-1(DIF(x_in) S^) mod prime pi."""
        log_n, tm, q = n.bit_length() - 1, tab[pi, :N], qs[pi]
        return stages(mont_mul(stages(x_in, log_n, tm, False, q, dif=True), s_hat, int(q)), log_n, tm,
                      True, q, dif=False)

    def residues(values, length, n, pi):
        v = np.zeros(n, np.uint64)
        length = min(length, values.size)  # t may be shorter than 2k
        v[:length] = reduce_u32(values[:length].astype(np.uint64), qs[pi])
        return v

    for r in range(rows):
        P = [np.zeros(N // 2, np.uint64) for _ in range(3)]
        for rank in range(3):
            P[rank][0] = sv[r] if seed_tensor else seed
        t_row = tv[r * ldt : r * ldt + min(lt, 1 << levels)]
        for lv in range(levels):
            k = 1 << lv
            k2, log_n = 2 * k, (1 if lv == 0 else lv + 2)
            n = 1 << log_n
            S = [stages(residues(P[rank], k, n, rank), log_n, tab[rank, :N], False, qs[rank], dif=True)
                 for rank in range(3)]
            X = [product(rank, n, S[rank], residues(t_row, k2, n, rank)) for rank in range(3)]
            newton_crt(X, P, tab, N, log_n, k2, True)
            X = [product(rank, n, S[rank], residues(P[rank], k2, n, rank)) for rank in range(3)]
            newton_crt(X, P, tab, N, log_n, k2, False)
        kf = 1 << levels
        third = (kf + 2) // 3
        for rank in range(3):
            lo, hi = rank * third, min(kf, rank * third + third)
            o[r * kf + lo : r * kf + hi] = P[rank][lo:hi].astype(np.int64)


def newton_crt(X, P, tab, N, log_n, k2, two):
    """Rank j's third of [0, k2): the three ranks' residues scaled by n^-1
    2^32, Garner's CRT (and 2 - it), written into every rank's P."""
    at = N + 2 * log_n
    third = (k2 + 2) // 3
    for rank in range(3):
        i = np.arange(rank * third, min(k2, rank * third + third))
        y = [mul_shoup(X[j][i], tab[j, at], tab[j, at + 1], np.uint64(Q[j])) for j in range(3)]
        v = crt_mod_p(*y)
        if two:
            v = two_minus(v, i == 0)
        for j in range(3):
            P[j][i] = v


def reduce_u32(x, q):
    for _ in range(2):
        x = np.where(x >= q, x - q, x)
    return x


def ntt_levels(t, s0, out, ws, tables, rows, lt, k0, levels):
    """One ``cls_ntt_levels`` call: its six launches a level, as the C loop
    issues them, on the models above (the same carving of ws and tables)."""
    n_max = (4 * k0) << (levels - 1)
    w32 = ws[: 9 * rows * n_max]
    w64 = ws[9 * rows * n_max : 11 * rows * n_max].view(torch.int64)
    x, bhat = w32[: 6 * rows * n_max], w32[6 * rows * n_max :]
    two, sbuf = w64[: rows * n_max // 2], w64[rows * n_max // 2 :]
    at = 0
    for i in range(levels):
        k = k0 << i
        k2, n = 2 * k, 4 * k
        n1, r2 = ntt._split4(n)[0], 2 * rows
        table = tables[at : at + 3 * (3 * n + 4)]
        at += 3 * (3 * n + 4)
        s_in, s_out = (s0 if i == 0 else sbuf), (out if i == levels - 1 else sbuf)
        fwd, inv = F["InInt64"] | F["Twiddle"], F["Inverse"] | F["ScaleMont"] | F["OutCrt"]
        ntt_pass(t, s_in, x, table, r2, rows, min(lt, k2), k, lt, k, 0, r2 * n, n, n1, n // n1, 1, n,
                 fwd, 0, 3)
        ntt_rows(x, bhat, table, rows, rows, r2 * n, rows * n, n, n1, R_["StoreB"])
        ntt_pass(x, x, two, table, rows, rows, n, n, n, n, r2 * n, 0, n, n1, n // n1, 1, k2,
                 inv | F["TwoMinus"], 0, 3)
        ntt_pass(two, two, x, table, rows, rows, k2, k2, k2, k2, 0, rows * n, n, n1, n // n1, 1, n,
                 fwd, 0, 3)
        ntt_rows(x, bhat, table, rows, 0, rows * n, rows * n, n, n1, R_["BHat"])
        ntt_pass(x, x, s_out, table, rows, rows, n, n, n, n, rows * n, 0, n, n1, n // n1, 1, k2,
                 inv, 0, 3)


MODELS = {"cls_ntt_pass": ntt_pass, "cls_ntt_rows": ntt_rows, "cls_ntt_newton": ntt_newton,
          "cls_ntt_levels": ntt_levels}


@pytest.fixture
def k6(monkeypatch):
    """K6 launches run the models above; the polynomial engine's wrappers
    take their kernel paths on CPU tensors."""
    def launch(name, *args):
        assert name in MODELS and len(args) == len(_build.SIGNATURES[name]), name
        MODELS[name](*args)

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(ntt, "_plain", lambda x: False)


def _rand(rng, shape, hi=P):
    return rng.integers(0, hi, size=shape, dtype=np.uint64).astype(np.int64)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64))


def test_k6_constants_match_the_port():
    """The .cu's primes, flags and limits are the wrapper's; the pass table
    holds w^e, Shoup's companions, the stage table (w_2h^j 2^32 at h + j)
    and the two scales, the Newton table the stage table and n^-1 2^32 for
    every n <= N."""
    assert tuple(Q) == ntt.NTT_PRIMES and SMEM_N == ntt.SMEM_N
    assert NEWTON_MAX_N == ntt.NEWTON_MAX_N and SMEM_N <= ntt.NEWTON_N <= NEWTON_MAX_N
    assert (F["InInt64"], F["InProduct"], F["Inverse"], F["Twiddle"]) == (
        ntt._IN_INT64, ntt._IN_PRODUCT, ntt._INVERSE, ntt._TWIDDLE)
    assert (F["Scale"], F["ScaleMont"], F["OutInt64"], F["OutCrt"], F["TwoMinus"]) == (
        ntt._SCALE, ntt._SCALE_MONT, ntt._OUT_INT64, ntt._OUT_CRT, ntt._TWO_MINUS)
    assert (R_["Square"], R_["StoreB"], R_["BHat"]) == (
        ntt._ROW_SQUARE, ntt._ROW_STORE_B, ntt._ROW_BHAT)
    N = 16
    nt = ntt._newton_table_np(N).astype(np.uint64)
    for pi, q in enumerate(Q):
        for h in (1, 2, 4, 8):
            w = pow(ntt._generator(q), (q - 1) // (2 * h), q)
            assert [int(v) for v in nt[pi, h : 2 * h]] == [pow(w, j, q) * (1 << 32) % q for j in range(h)]
        scales = [pow(1 << lg, -1, q) * (1 << 32) % q for lg in range(5)]
        assert [int(v) for v in nt[pi, N::2]] == scales
        assert [int(v) for v in nt[pi, N + 1 :: 2]] == [(v << 32) // q for v in scales]
    n = 16
    tab = ntt._k6_table_np(n).astype(np.uint64)
    for pi, q in enumerate(Q):
        w = pow(ntt._generator(q), (q - 1) // n, q)
        assert pow(w, n // 2, q) == q - 1
        want = [pow(w, e, q) for e in range(n)]
        want += [pow(n, -1, q), pow(n, -1, q) * (1 << 32) % q]
        got = [int(v) for v in tab[pi, :n]] + [int(tab[pi, 3 * n]), int(tab[pi, 3 * n + 2])]
        assert got == want
        comp = list(tab[pi, n : 2 * n]) + [tab[pi, 3 * n + 1], tab[pi, 3 * n + 3]]
        assert [int(c) for c in comp] == [(v << 32) // q for v in want]
        assert list(tab[pi, 2 * n : 3 * n]) == list(ntt._stage_table_np(n, q))


@pytest.mark.parametrize("n", [4, 1 << 11, 1 << 12, 1 << 14])
def test_k6_product_decomposition(k6, n):
    """Two launches up to the one-pass limit, three above it (the four-step's
    column passes and the fused row pass); the product and the square equal JAX's
    prime-batched product and the plain version.  Every entry of the second
    factor is p - 1, so the residue adds wrap 32 bits mod q3."""
    rng = np.random.default_rng(n)
    a = _rand(rng, n // 2 + 1)
    b = np.full(n // 2 - 1, P - 1, np.int64)
    ap, bp = np.pad(a, (0, n - a.size)), np.pad(b, (0, n - b.size))
    want = np.asarray(_jmul(jnp.asarray(ap.astype(np.uint32)), jnp.asarray(bp.astype(np.uint32))))
    before = ntt.LAUNCHES["ntt"]
    got = ntt._k6_product(torch.from_numpy(a), torch.from_numpy(b), n)
    assert ntt.LAUNCHES["ntt"] - before == (2 if n <= SMEM_N else 3)
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
        want = ntt._transform_plain(x, inverse)
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
    ssp = tssp.SSP(t=torch.from_numpy(t), v=torch.from_numpy(v_rows))  # uint32, as JAX holds them
    got = tsnark.prover_polys(tsam.PRGKey(ENT_SEED, "cpu"), PROVE_OFFSET, ssp,
                              torch.from_numpy(wits), TINY)
    for g, w in zip(got, want):
        _eq(g, w)


def test_prover_polys_batch_matches_jax_on_k6(k6):
    """The batched stage on the kernel path: row j equals ``prover_polys``
    of statement j (row 0 the JAX prover's), and the batch of three issues
    the K6 launches of one statement: one v^2, one series inverse, one
    quotient product."""
    wits, t, v_rows, *want = _jax_prover_polys()
    ssp = tssp.SSP(t=torch.from_numpy(t), v=torch.from_numpy(v_rows))
    key = tsam.PRGKey(ENT_SEED, "cpu")
    w0 = torch.from_numpy(wits)
    stmts = torch.stack([w0, torch.ones_like(w0), 1 - w0])
    offs = [PROVE_OFFSET, PROVE_OFFSET + 413, PROVE_OFFSET - 77]
    before = ntt.LAUNCHES["ntt"]
    single = [tsnark.prover_polys(key, o, ssp, w, TINY) for o, w in zip(offs, stmts)]
    per_statement = (ntt.LAUNCHES["ntt"] - before) // 3
    before = ntt.LAUNCHES["ntt"]
    got = tsnark.prover_polys_batch(key, offs, ssp, stmts, TINY)
    assert ntt.LAUNCHES["ntt"] - before == per_statement > 0
    for j in range(3):
        for g, w in zip(got, single[j]):
            _eq(g[j], w)
    for g, w in zip(got, want):
        _eq(g[0], w)


@pytest.mark.parametrize("zero_top", [0, 3])
def test_batched_division_on_k6(k6, monkeypatch, zero_top):
    """num [B, ln] over one den on the kernel path: each row the 1-D
    division's quotient, in the launches of one division; the quotients'
    product broadcasts the one series inverse without
    ``torch.broadcast_shapes``, whose first call imports sympy (seconds)."""
    def no_sympy(*shapes):
        raise AssertionError("torch.broadcast_shapes on the kernel path")

    monkeypatch.setattr(torch, "broadcast_shapes", no_sympy)
    rng = np.random.default_rng(50 + zero_top)
    d, b = 40, 5
    t = _rand(rng, d)
    t[0] = max(t[0], 1)
    if zero_top:
        t[-zero_top:] = 0
    quot = _rand(rng, (b, d))
    tt = torch.from_numpy(t)
    num = ntt._poly_mul_plain(torch.from_numpy(np.pad(quot, ((0, 0), (0, 128 - d)))),
                              torch.from_numpy(np.pad(t, (0, 128 - d))))[:, : 2 * d - 1]
    degree, lead = ntt.poly_degree_and_lead(tt)
    before = ntt.LAUNCHES["ntt"]
    one = ntt.poly_div_exact_mod_p(num[0], tt, d, den_degree=degree, den_lead=lead)
    launches = ntt.LAUNCHES["ntt"] - before
    before = ntt.LAUNCHES["ntt"]
    got = ntt.poly_div_exact_mod_p(num, tt, d, den_degree=degree, den_lead=lead)
    assert ntt.LAUNCHES["ntt"] - before == launches
    _eq(got, quot)
    _eq(got[0], one)


INV_LEN = ntt.NEWTON_N // 4 + 1  # every level in the Newton launch, the top one at n = NEWTON_N


@functools.cache
def _inv_case():
    """t (entries in [1, p), runs of p - 1) and JAX's series inverse of it
    mod x^INV_LEN, jit'ed on the CPU: the inverse mod x^L, L <= INV_LEN, is
    its first L coefficients, so one compile serves every length."""
    rng = np.random.default_rng(31)
    t = _rand(rng, INV_LEN + 7)
    t[t == 0] = 1
    t[0] = t[5:40] = t[-30:] = P - 1
    inv = jax.jit(jntt.poly_inv_series_mod_p, static_argnums=1)(jnp.asarray(t.astype(np.uint32)), INV_LEN)
    return t, np.asarray(inv)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("out_len", [1, 2, 3, 5, INV_LEN - 1, INV_LEN])
def test_k6_newton_matches_jax(k6, out_len, seeded):
    """On the kernel path every level of n <= NEWTON_N is one launch (none
    for out_len 1); the inverse equals JAX's and the Newton launch's plain
    version, from a host seed or from t[0]^-1 on the device."""
    t, want = _inv_case()
    tt = torch.from_numpy(t)
    seed = pow(int(t[0]), P - 2, P) if seeded else None
    before = ntt.LAUNCHES["ntt"]
    got = ntt.poly_inv_series_mod_p(tt, out_len, seed=seed)
    assert ntt.LAUNCHES["ntt"] - before == (1 if out_len > 1 else 0)
    _eq(got, want[:out_len])
    levels = ntt._inv_levels(out_len)
    assert all(n <= ntt.NEWTON_N for _, n in levels)
    s0 = modp.invmod_p(tt[None, :1])
    _eq(ntt._newton_plain(tt[None], s0, levels)[0, :out_len], want[:out_len])


def test_k6_newton_batched_rows(k6):
    """A batched t is one cluster a row, each row's seed read on the device."""
    rng = np.random.default_rng(32)
    t = _rand(rng, (2, 3, 40))
    t[..., 0] = np.maximum(t[..., 0], 1)
    t[1, 2, :] = P - 1
    tt = torch.from_numpy(t)
    got = ntt.poly_inv_series_mod_p(tt, 37)
    t2 = tt.reshape(6, 40)
    want = ntt._newton_plain(t2, modp.invmod_p(t2[:, :1]), ntt._inv_levels(37))[:, :37]
    _eq(got, want.reshape(2, 3, 37))


def test_k6_levels_above_the_newton_launch(k6):
    """Past NEWTON_N a level is two three-launch products, the second reusing
    s's forward rows; the division's quotient product is three more: the
    inverse and the exact quotient equal the plain path's."""
    rng = np.random.default_rng(33)
    L = 2 * ntt.NEWTON_N // 4 + 1  # one level at n = 2 NEWTON_N
    t = _rand(rng, L)
    t[0], t[-20:] = P - 1, P - 1
    tt = torch.from_numpy(t)
    before = ntt.LAUNCHES["ntt"]
    got = ntt.poly_inv_series_mod_p(tt, L, seed=pow(P - 1, P - 2, P))
    assert ntt.LAUNCHES["ntt"] - before == 1 + 6
    levels = ntt._inv_levels(L)
    _eq(got, ntt._newton_plain(tt[None], torch.tensor([[P - 1]]), levels)[0, :L])
    quot = _rand(rng, L)
    num = ntt._poly_mul_plain(torch.from_numpy(np.pad(t, (0, 2 * 8192 - L))),
                              torch.from_numpy(np.pad(quot, (0, 2 * 8192 - L))))[: 2 * L - 1]
    before = ntt.LAUNCHES["ntt"]
    got = ntt.poly_div_exact_mod_p(num, tt, L, den_degree=L - 1, den_lead=int(t[-1]))
    assert ntt.LAUNCHES["ntt"] - before == 1 + 6 + 3
    _eq(got, quot)


@pytest.mark.parametrize("newton_n,launches", [(4096, 31), (8192, 25), (16384, 19)])
def test_release_level_plan(monkeypatch, newton_n, launches):
    """The release prover's K6 plan, recorded without running it: the
    division (v^2 - 1) / t at d = 2^15 has 15 Newton levels, n = 2, 8, 16,
    ..., 2^16; those with n <= N_c are one launch, each level above six (all
    of them one host call), the quotient's product three, and v^2 three
    more."""
    d = 1 << 15
    levels = ntt._inv_levels(d)
    assert [n for _, n in levels] == [2] + [1 << e for e in range(3, 17)]
    low = ntt._newton_split(levels, torch.zeros(d), None, 4096, newton_n)
    assert [n for _, n in levels[:low]] == [n for _, n in levels if n <= newton_n]
    names = []
    monkeypatch.setattr(_build, "launch", lambda name, *args: names.append(name))
    monkeypatch.setattr(ntt, "_plain", lambda x: False)
    monkeypatch.setattr(ntt, "NEWTON_N", newton_n)
    v = torch.ones(d, dtype=torch.int64)
    before = ntt.LAUNCHES["ntt"]
    num = ntt.poly_mul_mod_p(v, v)
    ntt.poly_div_exact_mod_p(num, v, d, den_degree=d - 1, den_lead=1)
    assert ntt.LAUNCHES["ntt"] - before == launches == 1 + 6 * (len(levels) - low) + 3 + 3
    product = ["cls_ntt_pass", "cls_ntt_rows", "cls_ntt_pass"]
    assert names == product + ["cls_ntt_newton", "cls_ntt_levels"] + product


def test_release_level_plan_for_a_batch(monkeypatch):
    """Ten statements' v^2 and division at release are the 31 launches of
    one statement's, in the same order: t's series inverse once, v^2 and
    the quotient's product each one product over the ten rows."""
    d, b = 1 << 15, 10
    names = []
    monkeypatch.setattr(_build, "launch", lambda name, *args: names.append((name, args)))
    monkeypatch.setattr(ntt, "_plain", lambda x: False)
    v = torch.ones(b, d, dtype=torch.int64)
    before = ntt.LAUNCHES["ntt"]
    num = ntt.poly_mul_mod_p(v, v)
    ntt.poly_div_exact_mod_p(num, v[0], d, den_degree=d - 1, den_lead=1)
    assert ntt.LAUNCHES["ntt"] - before == 31
    product = ["cls_ntt_pass", "cls_ntt_rows", "cls_ntt_pass"]
    assert [n for n, _ in names] == product + ["cls_ntt_newton", "cls_ntt_levels"] + product
    newton, levels = (args for n, args in names if n in ("cls_ntt_newton", "cls_ntt_levels"))
    assert newton[4] == levels[5] == 1  # the series inverse: one row
    assert names[0][1][4] == b and names[-3][1][4] == 2 * b  # v^2: b rows; the quotients: 2b
