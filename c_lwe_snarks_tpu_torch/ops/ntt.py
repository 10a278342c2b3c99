"""CRT-NTT polynomial engine over Z_p, p = 2^32 - 5, on int64 tensors.

Port of ``c_lwe_snarks_tpu/ops/ntt.py``.  p - 1 has
2-adicity 1, so each product runs over three NTT-friendly primes below
2^31.1 and is reconstructed mod p (exact: the integer coefficients of a
product of degree-< 2^15 polynomials with entries < p are < 2^79 <
q1 * q2 * q3).  A product of two residues is < 2^62.2, so butterflies use
plain int64 ``%`` — no Montgomery form.  The three primes run as a
leading tensor axis.  Only results mod p are part of the contract.

Given a mesh (``parallel.mesh``) of W > 1 ranks, a large 1-D product runs
as a 4-step (Bailey) transform split over the ranks (``_poly_mul_4step``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from . import modp

NTT_PRIMES = (2013265921, 1811939329, 2281701377)  # 15*2^27+1, 27*2^26+1, 17*2^27+1


@functools.cache
def _generator(q: int) -> int:
    """Smallest primitive root of the prime q."""
    fs, m, f = set(), q - 1, 2
    while f * f <= m:
        while m % f == 0:
            fs.add(f)
            m //= f
        f += 1
    if m > 1:
        fs.add(m)
    g = 2
    while any(pow(g, (q - 1) // f, q) == 1 for f in fs):
        g += 1
    return g


def _powers_np(w: int, count: int, q: int) -> np.ndarray:
    """[1, w, ..., w^(count-1)] mod q (products < 2^63 in uint64)."""
    out = np.ones(1, np.uint64)
    wp = w % q
    while out.shape[0] < count:
        out = np.concatenate([out, out * np.uint64(wp) % np.uint64(q)])
        wp = wp * wp % q
    return out[:count]


@functools.cache
def _tables_np(n: int):
    """Bit reversal and per-stage (fwd, inv) twiddles [3, half], n^-1 [3]."""
    logn = n.bit_length() - 1
    assert 1 << logn == n
    rev = np.zeros(n, np.int64)
    for b in range(logn):
        rev |= ((np.arange(n) >> b) & 1) << (logn - 1 - b)
    fwd, inv = [], []
    for s in range(1, logn + 1):
        half = 1 << (s - 1)
        ws = [pow(_generator(q), (q - 1) >> s, q) for q in NTT_PRIMES]
        fwd.append(np.stack([_powers_np(w, half, q) for w, q in zip(ws, NTT_PRIMES)]))
        inv.append(np.stack([
            _powers_np(pow(w, q - 2, q), half, q) for w, q in zip(ws, NTT_PRIMES)]))
    n_inv = np.array([pow(n, q - 2, q) for q in NTT_PRIMES], np.uint64)
    return rev, fwd, inv, n_inv


def _tables(n: int, device):
    rev, fwd, inv, n_inv = _tables_np(n)
    t = lambda a: torch.tensor(a.astype(np.int64), device=device)
    return t(rev), [t(x) for x in fwd], [t(x) for x in inv], t(n_inv)


def _qs(ndim: int, device) -> torch.Tensor:
    return torch.tensor(NTT_PRIMES, device=device).reshape((3,) + (1,) * (ndim - 1))


def _ntt(x: torch.Tensor, stage_tw, rev) -> torch.Tensor:
    """Radix-2 DIT NTT along the last axis; x int64 [3, ..., n] mod q."""
    n = x.shape[-1]
    x = x[..., rev]
    q = _qs(x.dim() + 1, x.device)
    for s, tw in enumerate(stage_tw, start=1):
        length = 1 << s
        half = length // 2
        v = x.reshape(*x.shape[:-1], n // length, 2, half)
        u, w = v[..., 0, :], v[..., 1, :]
        twb = tw.reshape((3,) + (1,) * (x.dim() - 1) + (half,))
        wv = w * twb % q
        x = torch.stack([(u + wv) % q, (u - wv) % q], dim=-2).reshape(x.shape)
    return x


def _poly_mul_cyclic(ap: torch.Tensor, bp: torch.Tensor | None) -> torch.Tensor:
    """Cyclic product mod p of padded pow2-length arrays (bp None: square)."""
    n = ap.shape[-1]
    rev, fwd, inv, n_inv = _tables(n, ap.device)
    if bp is None:
        xs = ap.expand(3, *ap.shape)
        q = _qs(xs.dim(), ap.device)
        f = _ntt(xs % q, fwd, rev)
        prod = f * f % q
    else:
        ap, bp = torch.broadcast_tensors(ap, bp)
        xs = torch.stack([ap, bp]).expand(3, 2, *ap.shape)
        q = _qs(xs.dim(), ap.device)
        f = _ntt(xs % q, fwd, rev)
        q = _qs(f.dim() - 1, ap.device)
        prod = f[:, 0] * f[:, 1] % q
    out = _ntt(prod, inv, rev)
    out = out * n_inv.reshape((3,) + (1,) * (out.dim() - 1)) % _qs(out.dim(), ap.device)
    return crt_to_mod_p(out[0], out[1], out[2])


_Q1, _Q2, _Q3 = NTT_PRIMES
_INV_Q1_MOD_Q2 = pow(_Q1, -1, _Q2)
_INV_Q1Q2_MOD_Q3 = pow(_Q1 * _Q2, -1, _Q3)


def crt_to_mod_p(r1: torch.Tensor, r2: torch.Tensor, r3: torch.Tensor) -> torch.Tensor:
    """Residues mod (q1, q2, q3) -> value mod p (value < q1*q2*q3), Garner."""
    t2 = (r2 - r1) % _Q2 * _INV_Q1_MOD_Q2 % _Q2
    u = ((r3 - r1) % _Q3 - (_Q1 % _Q3) * t2 % _Q3) % _Q3
    t3 = u * _INV_Q1Q2_MOD_Q3 % _Q3
    # x = r1 + q1 * t2 + q1 * q2 * t3; every term reduced mod p
    return (r1 + modp.mulmod_p(_Q1 % modp.P, t2)
            + modp.mulmod_p(_Q1 * _Q2 % modp.P, t3)) % modp.P


# --------------------------------------------------------------------------
# The 4-step (Bailey) transform over a 1-D mesh of ranks.
#
# A length N = n1 * n2 is the matrix x[j1 * n2 + j2] = A[j1, j2].  Rank r
# takes the columns j2 of its chunk (the operands are whole on every rank),
# runs the n1-point transforms over j1, scales by w_N^(j2 * k1), and one
# all_to_all_single turns its column block into a row block over k1; the
# n2-point transforms over j2 then give X[k1 + n1 * k2].  The pointwise
# product happens in that layout and the inverse mirrors every step.  So a
# product moves each residue array three times (fwd a, fwd b, inverse; a
# square twice), then one all_gather makes the result whole on every rank.
# --------------------------------------------------------------------------


def _split4(n: int) -> tuple[int, int]:
    logn = n.bit_length() - 1
    n1 = 1 << (logn - logn // 2)
    return n1, n // n1


@functools.cache
def _twiddle4_np(n1: int, n2: int, inverse: bool) -> np.ndarray:
    """int64 [3, n2, n1]: w_N^(+-j2 * k1) mod each prime, N = n1 * n2."""
    out = []
    for q in NTT_PRIMES:
        w = pow(_generator(q), (q - 1) // (n1 * n2), q)
        if inverse:
            w = pow(w, q - 2, q)
        col = _powers_np(w, n2, q)  # w^j2
        tab = np.empty((n2, n1), np.uint64)
        tab[:, 0] = 1
        for k1 in range(1, n1):
            tab[:, k1] = tab[:, k1 - 1] * col % np.uint64(q)
        out.append(tab)
    return np.stack(out).astype(np.int64)


def _transpose_sharded(y: torch.Tensor, group, world: int) -> torch.Tensor:
    """[3, r, c] (rows of this rank, all columns) -> [3, c / world, world * r]
    (this rank's chunk of the columns, all rows, transposed): one
    all_to_all_single, which splits dim 0 into world contiguous chunks."""
    _, r, c = y.shape
    cw = c // world
    send = y.reshape(3, r, world, cw).permute(2, 0, 1, 3).contiguous()  # [dest, 3, r, cw]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)  # [src, 3, r, cw]
    return recv.permute(1, 3, 0, 2).reshape(3, cw, world * r)


def _poly_mul_4step(ap: torch.Tensor, bp: torch.Tensor | None, mesh) -> torch.Tensor:
    """Cyclic product mod p of padded length-n arrays, whole on every rank of
    the mesh (bp None: square); equal to ``_poly_mul_cyclic``."""
    group, rank, world = mesh.get_group(), mesh.get_local_rank(), mesh.size()
    n = ap.shape[-1]
    n1, n2 = _split4(n)
    c = n2 // world
    dev = ap.device
    rev1, fwd1, inv1, n1_inv = _tables(n1, dev)
    rev2, fwd2, inv2, n2_inv = _tables(n2, dev)
    tw_f, tw_i = (torch.tensor(_twiddle4_np(n1, n2, inv)[:, rank * c : (rank + 1) * c], device=dev)
                  for inv in (False, True))  # [3, c, n1]
    q = _qs(3, dev)

    def fwd(x):
        cols = x.reshape(n1, n2)[:, rank * c : (rank + 1) * c].T  # [c (j2), n1 (j1)]
        y = _ntt(cols.expand(3, c, n1) % q, fwd1, rev1) * tw_f % q  # j1 -> k1
        return _ntt(_transpose_sharded(y, group, world), fwd2, rev2)  # [3, n1/W, n2]: j2 -> k2

    fa = fwd(ap)
    prod = fa * (fa if bp is None else fwd(bp)) % q
    y = _ntt(prod, inv2, rev2) * n2_inv.reshape(3, 1, 1) % q  # k2 -> j2
    y = _transpose_sharded(y, group, world) * tw_i % q  # [3, c (j2), n1 (k1)]
    y = _ntt(y, inv1, rev1) * n1_inv.reshape(3, 1, 1) % q  # k1 -> j1
    part = crt_to_mod_p(y[0], y[1], y[2]).contiguous()  # [c, n1]
    out = torch.empty(world, c, n1, dtype=part.dtype, device=dev)
    dist.all_gather(list(out.unbind(0)), part, group=group)
    return out.reshape(n2, n1).T.reshape(n)


def _shardable(n: int, a: torch.Tensor, b: torch.Tensor, mesh, min_n: int) -> bool:
    """The 4-step rule: W > 1 ranks, 1-D operands, n >= min_n, and W
    divides both n1 and n2."""
    if mesh is None or a.dim() != 1 or b.dim() != 1 or n < min_n:
        return False
    n1, n2 = _split4(n)
    world = mesh.size()
    return world > 1 and n1 % world == 0 and n2 % world == 0


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def poly_mul_mod_p(
    a: torch.Tensor, b: torch.Tensor, out_len: int | None = None, *, mesh=None,
    min_shard_n: int = 4096,
) -> torch.Tensor:
    """Full product of coefficient arrays mod p, truncated/padded to out_len.

    With ``mesh``, a 1-D product whose padded length n >= min_shard_n runs
    on the 4-step transform split over the ranks (``_shardable``); the
    result is whole on every rank and equal to the one-device product."""
    la, lb = a.shape[-1], b.shape[-1]
    full = la + lb - 1
    if out_len is None:
        out_len = full
    n = _next_pow2(max(full, 2))
    ap = torch.nn.functional.pad(a, (0, n - la))
    bp = None if a is b else torch.nn.functional.pad(b, (0, n - lb))
    if _shardable(n, a, b, mesh, min_shard_n):
        out = _poly_mul_4step(ap, bp, mesh)
    else:
        out = _poly_mul_cyclic(ap, bp)
    out = out[..., : min(out_len, full)]
    if out_len > full:
        out = torch.nn.functional.pad(out, (0, out_len - full))
    return out


def poly_inv_series_mod_p(
    t: torch.Tensor, out_len: int, *, mesh=None, min_shard_n: int = 4096
) -> torch.Tensor:
    """Power-series inverse of t mod x^out_len (t[0] invertible), Newton;
    with ``mesh`` the large levels run on the 4-step transform."""
    s = modp.invmod_p(t[..., :1])
    k = 1
    while k < out_len:
        k2 = min(2 * k, _next_pow2(out_len))
        ts = poly_mul_mod_p(t[..., :k2], s, out_len=k2, mesh=mesh, min_shard_n=min_shard_n)
        two = torch.zeros_like(ts)
        two[..., 0] = 2
        s = poly_mul_mod_p(s, modp.submod_p(two, ts), out_len=k2, mesh=mesh,
                           min_shard_n=min_shard_n)
        k = k2
    return s[..., :out_len]


def poly_true_degree(x: torch.Tensor) -> int:
    """Index of the highest nonzero coefficient (-1 for the zero poly)."""
    nz = torch.nonzero(x).flatten()
    return int(nz[-1]) if nz.numel() else -1


def _div_rev_core(
    num: torch.Tensor, den: torch.Tensor, ql: int, mesh=None, min_shard_n: int = 4096
) -> torch.Tensor:
    """Reversed-series exact division; den's last formal entry nonzero."""
    inv = poly_inv_series_mod_p(torch.flip(den, (-1,)), ql, mesh=mesh, min_shard_n=min_shard_n)
    qr = poly_mul_mod_p(torch.flip(num, (-1,))[..., :ql], inv, out_len=ql, mesh=mesh,
                        min_shard_n=min_shard_n)
    return torch.flip(qr, (-1,))


def _fit_len(q: torch.Tensor, out_len: int) -> torch.Tensor:
    if q.shape[-1] >= out_len:
        return q[..., :out_len]
    return torch.nn.functional.pad(q, (0, out_len - q.shape[-1]))


def poly_div_exact_mod_p(
    num: torch.Tensor, den: torch.Tensor, quot_len: int, *, mesh=None, min_shard_n: int = 4096
) -> torch.Tensor:
    """Exact quotient num / den mod p with FLINT true-degree semantics.

    When den's last formal coefficient is zero both operands are shifted
    by x^(ld-1-deg den), so the reversed series inverts a nonzero
    constant.  Returns the low quot_len coefficients of the quotient.
    With ``mesh`` the large products run on the 4-step transform.
    """
    assert num.dim() == 1 and den.dim() == 1, "division is single-polynomial"
    ln, ld = num.shape[-1], den.shape[-1]
    # den is whole on every rank, so every rank takes the same branch and
    # issues the same collectives
    shift = ld - 1 - poly_true_degree(den)
    if shift == 0:
        return _fit_len(_div_rev_core(num, den, max(ln - ld + 1, 1), mesh, min_shard_n), quot_len)
    num2 = torch.roll(torch.nn.functional.pad(num, (0, ld - 1)), shift)
    den2 = torch.roll(den, shift)
    return _fit_len(_div_rev_core(num2, den2, ln, mesh, min_shard_n), quot_len)
