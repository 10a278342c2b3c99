"""CRT-NTT polynomial engine over Z_p, p = 2^32 - 5, on int64 tensors.

Port of ``c_lwe_snarks_tpu/ops/ntt.py``.  p - 1 has
2-adicity 1, so each product runs over three NTT-friendly primes below
2^31.1 and is reconstructed mod p (exact: the integer coefficients of a
product of degree-< 2^15 polynomials with entries < p are < 2^79 <
q1 * q2 * q3).  Only results mod p are part of the contract.

On a CUDA tensor every transform is K6 (``csrc/ntt.cu``): a product is
two launches for n <= ``SMEM_N`` and three above (a four-step whose row
pass is fused), over all three primes and the batch, with the pointwise
product, the n^-1 scale and the CRT inside the inverse; a series
inverse runs its Newton levels of n <= ``NEWTON_N`` in one launch (a
cluster of three CTAs a row) and each level above as two three-launch
products issued by one host call; tables are built once per (n, device).
``LAUNCHES`` counts kernel launches.  On the CPU the plain version runs:
radix-2 stages in int64 (a product of two residues is < 2^62.2, so
butterflies use plain ``%``), the three primes as a leading tensor axis.

Given a mesh (``parallel.mesh``) of W > 1 ranks, a large 1-D product runs
as a 4-step (Bailey) transform split over the ranks (``_poly_mul_4step``);
its local transforms are K6 launches on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from . import _build, modp

NTT_PRIMES = (2013265921, 1811939329, 2281701377)  # 15*2^27+1, 27*2^26+1, 17*2^27+1
SMEM_N = 4096  # residues of one prime a K6 pass holds (csrc/ntt.cu: kSmemN); above, four-step
NEWTON_N = 4096  # the Newton launch takes every level of product length n <= NEWTON_N
NEWTON_MAX_N = 16384  # the longest n a Newton CTA holds (csrc/ntt.cu: kNewtonMaxN)

LAUNCHES = {"ntt": 0}


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


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on the device: from pinned memory, without a host sync."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@functools.cache
def _tables(n: int, device):
    """The plain version's tables of ``_tables_np`` on a device, made once."""
    rev, fwd, inv, n_inv = _tables_np(n)
    t = lambda a: _upload(a.astype(np.int64), device)
    return t(rev), [t(x) for x in fwd], [t(x) for x in inv], t(n_inv)


@functools.cache
def _qs(ndim: int, device) -> torch.Tensor:
    return _upload(np.array(NTT_PRIMES, np.int64), device).reshape((3,) + (1,) * (ndim - 1))


def _ntt(x: torch.Tensor, stage_tw, rev, q: torch.Tensor | None = None) -> torch.Tensor:
    """Radix-2 DIT NTT along the last axis; x int64 [np, ..., n] mod the
    primes q (default the three, [3, 1, ...]), stage twiddles [np, half]."""
    n = x.shape[-1]
    x = x[..., rev]
    q = _qs(x.dim() + 1, x.device) if q is None else q
    for s, tw in enumerate(stage_tw, start=1):
        length = 1 << s
        half = length // 2
        v = x.reshape(*x.shape[:-1], n // length, 2, half)
        u, w = v[..., 0, :], v[..., 1, :]
        twb = tw.reshape((tw.shape[0],) + (1,) * (x.dim() - 1) + (half,))
        wv = w * twb % q
        x = torch.stack([(u + wv) % q, (u - wv) % q], dim=-2).reshape(x.shape)
    return x


def _poly_mul_plain(ap: torch.Tensor, bp: torch.Tensor | None) -> torch.Tensor:
    """K6's plain version: cyclic product mod p of padded pow2-length
    arrays (bp None: square)."""
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


def _fit_len(q: torch.Tensor, out_len: int) -> torch.Tensor:
    """The last axis cut or zero-padded to out_len."""
    if q.shape[-1] >= out_len:
        return q[..., :out_len]
    return torch.nn.functional.pad(q, (0, out_len - q.shape[-1]))


def _plain(x: torch.Tensor) -> bool:
    """True on the CPU, where K6's wrappers run their plain versions; a CUDA
    tensor goes through the kernels, any other device raises."""
    if x.device.type == "cpu":
        return True
    _require_cuda(x)
    return False


def _poly_mul_cyclic(a: torch.Tensor, b: torch.Tensor | None, n: int | None = None) -> torch.Tensor:
    """Cyclic product mod p at length n (default a's) of arrays of at most n
    entries, zero-padded to n (b None: square).  K6 on a CUDA tensor, two
    or three launches (``_k6_product``); the plain version on the CPU."""
    n = a.shape[-1] if n is None else n
    if _plain(a):
        return _poly_mul_plain(_fit_len(a, n), None if b is None else _fit_len(b, n))
    return _k6_product(a, b, n)


# --------------------------------------------------------------------------
# K6 (csrc/ntt.cu): cls_ntt_pass is one pass over all primes and the batch,
# cls_ntt_rows the four-step's fused row pass of a product, cls_ntt_newton
# the low Newton levels of a series inverse in one launch.
# --------------------------------------------------------------------------

# pass flags, as csrc/ntt.cu names them
_IN_INT64, _IN_PRODUCT, _INVERSE, _TWIDDLE = 1, 2, 4, 8
_SCALE, _SCALE_MONT, _OUT_INT64, _OUT_CRT, _TWO_MINUS = 16, 32, 64, 128, 256
# row-pass flags
_ROW_SQUARE, _ROW_STORE_B, _ROW_BHAT = 1, 2, 4


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")


def _stage_table_np(n: int, q: int) -> np.ndarray:
    """uint64 [n]: entry h + j = w_2h^j * 2^32 mod q for each stage half h < n
    (a power of two) and j < h (entry 0 unused, 0), w_2h the plain version's
    root; a butterfly multiplies by it in Montgomery form."""
    out = np.zeros(n, np.uint64)
    h = 1
    while h < n:
        w = pow(_generator(q), (q - 1) // (2 * h), q)
        out[h : 2 * h] = _powers_np(w, h, q) * np.uint64(1 << 16) % np.uint64(q) * np.uint64(1 << 16) % np.uint64(q)
        h *= 2
    return out


@functools.cache
def _k6_table_np(n: int) -> np.ndarray:
    """uint32 [3, 3n + 4] per prime: w^e and Shoup's floor(w^e * 2^32 / q)
    for e < n (w a primitive n-th root of unity, the plain version's roots),
    the stage table (``_stage_table_np``), then n^-1, n^-1 * 2^32 mod q and
    their Shoup companions."""
    rows = []
    for q in NTT_PRIMES:
        w = pow(_generator(q), (q - 1) // n, q)
        pw = _powers_np(w, n, q)
        n_inv = pow(n, q - 2, q)
        scale = np.array([n_inv, n_inv * (1 << 32) % q], np.uint64)
        shoup = lambda x: (x << np.uint64(32)) // np.uint64(q)
        rows.append(np.concatenate([pw, shoup(pw), _stage_table_np(n, q),
                                    np.stack([scale, shoup(scale)], 1).reshape(-1)]))
    return np.stack(rows).astype(np.uint32)


@functools.cache
def _k6_table(n: int, device) -> torch.Tensor:
    """``_k6_table_np`` on the device (int32 bits), uploaded once."""
    return _upload(_k6_table_np(n).view(np.int32), device)


def _k6_pass(inp, in2, out, table, *, rows, n, L, cols_pass, flags, rows_a=None, len_a=None,
             len_b=None, lda=None, ldb=None, in_pstride=0, out_pstride=0, out_len=None, p0=0,
             np_=3) -> None:
    """One ``cls_ntt_pass`` launch: rows x (n / L) transforms of length L, as
    the columns (stride n / L) or the rows (stride 1) of each row's
    [n / L, L] view.  int64 inputs: rows_a rows of len_a entries at stride
    lda, then rows of len_b at ldb; a CRT store writes out_len entries a row."""
    istride, tstride = (n // L, 1) if cols_pass else (1, L)
    len_a = n if len_a is None else len_a
    len_b = n if len_b is None else len_b
    _build.launch(
        "cls_ntt_pass", inp, in2, out, table, rows, rows if rows_a is None else rows_a, len_a,
        len_b, len_a if lda is None else lda, len_b if ldb is None else ldb, in_pstride,
        out_pstride, n, L, istride, tstride, n if out_len is None else out_len, flags, p0, np_)
    LAUNCHES["ntt"] += 1


def _k6_rows(x, bhat, table, *, rows, n, flags, x_pstride, b_off=0, h_pstride=0) -> None:
    """One ``cls_ntt_rows`` launch: the row pass of rows products at length
    n, in place on the first operand's rows of x (the second's at b_off
    rows further, or bhat's already transformed ones)."""
    _build.launch("cls_ntt_rows", x, bhat, table, rows, b_off, x_pstride, h_pstride, n,
                  _split4(n)[0], flags)
    LAUNCHES["ntt"] += 1


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def _scratch(ws: torch.Tensor | None, numel: int, device) -> torch.Tensor:
    """numel int32 words: the front of the caller's workspace, else new."""
    if ws is not None and ws.numel() >= numel:
        return ws[:numel]
    return torch.empty(numel, dtype=torch.int32, device=device)


def _k6_product(a: torch.Tensor, b: torch.Tensor | None, n: int,
                ws: torch.Tensor | None = None) -> torch.Tensor:
    """int64 [..., n]: the cyclic product mod p of a and b (or a^2).

    Up to SMEM_N: forward of both operands in one pass (their rows one
    batch, read as int64 and zero-extended to n), then the inverse with the
    Montgomery pointwise product at its load and the scale and CRT at its
    store.  Above: the four-step's forward column pass, the fused row pass
    (forward rows, product, inverse rows) and the inverse column pass with
    the scale and the CRT.  Residues live in one uint32 scratch [3, rows,
    n], taken from ``ws`` when it is large enough."""
    if b is not None and a.shape[:-1] != b.shape[:-1]:
        lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        a, b = a.expand(*lead, a.shape[-1]), b.expand(*lead, b.shape[-1])
    lead = a.shape[:-1]
    a2 = _rows(a)
    b2 = a2 if b is None else _rows(b)
    nb = a2.shape[0]
    rows = nb if b is None else 2 * nb
    table = _k6_table(n, a.device)
    flat = _scratch(ws, 3 * rows * n, a.device)
    scratch = flat.view(3, rows, n)
    out = torch.empty(nb, n, dtype=torch.int64, device=a.device)
    fwd = dict(rows=rows, rows_a=nb, len_a=a2.shape[-1], len_b=b2.shape[-1], out_pstride=rows * n)
    res = dict(rows=nb, n=n, in_pstride=rows * n)
    if n <= SMEM_N:
        fb = flat if b is None else flat[nb * n :]  # the second factor's rows, or the first's again
        _k6_pass(a2, b2, scratch, table, n=n, L=n, cols_pass=False, flags=_IN_INT64, **fwd)
        _k6_pass(scratch, fb, out, table, L=n, cols_pass=False,
                 flags=_IN_PRODUCT | _INVERSE | _SCALE_MONT | _OUT_CRT, **res)
    else:
        n1, _ = _split4(n)
        _k6_pass(a2, b2, scratch, table, n=n, L=n1, cols_pass=True, flags=_IN_INT64 | _TWIDDLE,
                 **fwd)
        _k6_rows(scratch, scratch, table, rows=nb, n=n, b_off=nb, x_pstride=rows * n,
                 flags=_ROW_SQUARE if b is None else 0)
        _k6_pass(scratch, scratch, out, table, L=n1, cols_pass=True,
                 flags=_INVERSE | _SCALE_MONT | _OUT_CRT, **res)
    return out.reshape(*lead, n)


def _k6_transform(x: torch.Tensor, inverse: bool, p0: int = 0) -> torch.Tensor:
    """int64 residues [np, ..., n] of primes p0 .. p0 + np - 1 -> their
    transforms in natural order (inverse: scaled by n^-1)."""
    np_, n = x.shape[0], x.shape[-1]
    x = x.contiguous()
    rows = x.numel() // (np_ * n)
    table = _k6_table(n, x.device)
    out = torch.empty_like(x)
    kw = dict(rows=rows, n=n, p0=p0, np_=np_, in_pstride=rows * n, out_pstride=rows * n)
    if n <= SMEM_N:
        flags = _IN_INT64 | _OUT_INT64 | (_INVERSE | _SCALE if inverse else 0)
        _k6_pass(x, x, out, table, L=n, cols_pass=False, flags=flags, **kw)
        return out
    n1, n2 = _split4(n)
    scratch = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if not inverse:
        _k6_pass(x, x, scratch, table, L=n1, cols_pass=True, flags=_IN_INT64 | _TWIDDLE, **kw)
        _k6_pass(scratch, scratch, out, table, L=n2, cols_pass=False, flags=_OUT_INT64, **kw)
        return out.reshape(np_, rows, n1, n2).transpose(-1, -2).reshape(x.shape)  # X[k1 + n1 k2]
    xt = x.reshape(np_, rows, n2, n1).transpose(-1, -2).contiguous()  # [k1, k2]
    _k6_pass(xt, xt, scratch, table, L=n2, cols_pass=False,
             flags=_IN_INT64 | _INVERSE | _TWIDDLE, **kw)
    _k6_pass(scratch, scratch, out, table, L=n1, cols_pass=True,
             flags=_INVERSE | _SCALE | _OUT_INT64, **kw)
    return out


def _transform(x: torch.Tensor, inverse: bool, p0: int = 0) -> torch.Tensor:
    """Residues [np, ..., n] of primes p0.. -> their NTTs in natural order
    (inverse: scaled by n^-1): K6 on a CUDA tensor, the plain version on
    the CPU."""
    if _plain(x):
        return _transform_plain(x, inverse, p0)
    return _k6_transform(x, inverse, p0)


def _transform_plain(x: torch.Tensor, inverse: bool, p0: int = 0) -> torch.Tensor:
    """The plain version of ``_k6_transform``: ``_ntt`` and the scale."""
    n = x.shape[-1]
    rev, fwd, inv, n_inv = _tables(n, x.device)
    lo, hi = p0, p0 + x.shape[0]
    q = _qs(x.dim(), x.device)[lo:hi]
    out = _ntt(x, [tw[lo:hi] for tw in (inv if inverse else fwd)], rev, _qs(x.dim() + 1, x.device)[lo:hi])
    if inverse:
        out = out * n_inv[lo:hi].reshape((-1,) + (1,) * (x.dim() - 1)) % q
    return out


def _prime_index(q: int) -> int:
    if q not in NTT_PRIMES:
        raise ValueError(f"q must be one of NTT_PRIMES {NTT_PRIMES}, got {q}")
    return NTT_PRIMES.index(q)


def ntt_forward(x: torch.Tensor, q: int) -> torch.Tensor:
    """NTT mod q (one of ``NTT_PRIMES``) along the last axis, natural order:
    X[k] = sum_j x[j] w^(jk), w = g^((q - 1) / n).  x: int64 [..., n] < q."""
    return _transform(x[None], False, _prime_index(q))[0]


def ntt_inverse(x: torch.Tensor, q: int) -> torch.Tensor:
    """The inverse of ``ntt_forward``, scaled by n^-1."""
    return _transform(x[None], True, _prime_index(q))[0]


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


@functools.cache
def _twiddle4(n1: int, n2: int, inverse: bool, device) -> torch.Tensor:
    """``_twiddle4_np`` on the device, uploaded once."""
    return _upload(_twiddle4_np(n1, n2, inverse), device)


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
    tw_f, tw_i = (_twiddle4(n1, n2, inv, dev)[:, rank * c : (rank + 1) * c]
                  for inv in (False, True))  # [3, c, n1]
    q = _qs(3, dev)

    def fwd(x):
        cols = x.reshape(n1, n2)[:, rank * c : (rank + 1) * c].T  # [c (j2), n1 (j1)]
        y = _transform(cols.expand(3, c, n1) % q, False) * tw_f % q  # j1 -> k1
        return _transform(_transpose_sharded(y, group, world), False)  # [3, n1/W, n2]: j2 -> k2

    fa = fwd(ap)
    prod = fa * (fa if bp is None else fwd(bp)) % q
    y = _transform(prod, True)  # k2 -> j2
    y = _transpose_sharded(y, group, world) * tw_i % q  # [3, c (j2), n1 (k1)]
    y = _transform(y, True)  # k1 -> j1
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
    result is whole on every rank and equal to the one-device product.
    Operands: int64 or uint32 words (``modp.words``); the product is int64."""
    square = a is b
    a = modp.words(a)
    b = a if square else modp.words(b)
    la, lb = a.shape[-1], b.shape[-1]
    full = la + lb - 1
    if out_len is None:
        out_len = full
    n = _next_pow2(max(full, 2))
    if _shardable(n, a, b, mesh, min_shard_n):
        out = _poly_mul_4step(_fit_len(a, n), None if square else _fit_len(b, n), mesh)
    else:
        out = _poly_mul_cyclic(a, None if square else b, n)
    out = out[..., : min(out_len, full)]
    if out_len > full:
        out = torch.nn.functional.pad(out, (0, out_len - full))
    return out


def _inv_levels(out_len: int) -> list[tuple[int, int]]:
    """(k, n) of each Newton level of a series inverse mod x^out_len: s mod
    x^k -> s mod x^2k by two products at length n = 4k (2 at k = 1), which
    holds either product whole (at most 3k - 1 coefficients)."""
    levels, k = [], 1
    while k < out_len:
        levels.append((k, 2 if k == 1 else 4 * k))
        k *= 2
    return levels


def _newton_split(levels, t: torch.Tensor, mesh, min_shard_n: int, newton_n: int) -> int:
    """How many of the levels the Newton launch takes: the leading ones of
    n <= newton_n that do not run on a mesh's 4-step."""
    low = 0
    while (low < len(levels) and levels[low][1] <= newton_n
           and not _shardable(levels[low][1], t, t, mesh, min_shard_n)):
        low += 1
    return low


@functools.cache
def _newton_table_np(N: int) -> np.ndarray:
    """uint32 [3, N + 2 (log2 N + 1)] per prime: the stage table of N
    (``_stage_table_np``: every level's transform reads its first n
    entries), then for log2 n = 0 .. log2 N: n^-1 * 2^32 mod q and its
    Shoup companion."""
    rows = []
    for q in NTT_PRIMES:
        shoup = lambda x: (x << np.uint64(32)) // np.uint64(q)
        scales = np.array([pow(1 << lg, q - 2, q) * (1 << 32) % q
                           for lg in range(N.bit_length())], np.uint64)
        rows.append(np.concatenate([_stage_table_np(N, q), np.stack([scales, shoup(scales)], 1).reshape(-1)]))
    return np.stack(rows).astype(np.uint32)


@functools.cache
def _newton_table(N: int, device) -> torch.Tensor:
    return _upload(_newton_table_np(N).view(np.int32), device)


def _k6_newton(t2: torch.Tensor, s0: torch.Tensor | None, seed: int | None,
               levels: int, N: int) -> torch.Tensor:
    """K6's Newton launch: int64 [rows, 2^levels], the inverse series of each
    row of t2 (int64 [rows, lt], contiguous) after ``levels`` Newton levels
    from t2[:, 0]^-1 (s0 [rows, 1] on the device, or the host int seed), one
    cluster of three CTAs a row; every level's n at most N, N >= 4."""
    rows, lt = t2.shape
    out = torch.empty(rows, 1 << levels, dtype=torch.int64, device=t2.device)
    _build.launch("cls_ntt_newton", t2, out if s0 is None else s0.contiguous(), out,
                  _newton_table(N, t2.device), rows, lt, lt, levels, N,
                  0 if seed is None else seed, int(s0 is not None))
    LAUNCHES["ntt"] += 1
    return out


def _two_minus(ts: torch.Tensor) -> torch.Tensor:
    """2 - ts mod p: the 2 added in place (no host scalar copied)."""
    out = modp.submod_p(0, ts)
    out[..., 0].add_(2).remainder_(modp.P)
    return out


def _newton_plain(t2: torch.Tensor, s: torch.Tensor, levels) -> torch.Tensor:
    """The Newton launch's plain version: the same levels, each two products
    by ``_poly_mul_plain`` at the level's n."""
    for k, n in levels:
        k2 = 2 * k
        ts = _poly_mul_plain(_fit_len(t2[..., :k2], n), _fit_len(s, n))[..., :k2]
        s = _poly_mul_plain(_fit_len(s, n), _fit_len(_two_minus(ts), n))[..., :k2]
    return s


@functools.cache
def _k6_tables(ns: tuple, device) -> torch.Tensor:
    """The pass tables of the lengths ns, one after another, uploaded once."""
    return _upload(np.concatenate([_k6_table_np(n).reshape(-1) for n in ns]).view(np.int32), device)


def _k6_levels(t2: torch.Tensor, s: torch.Tensor, levels, ws: torch.Tensor) -> torch.Tensor:
    """Newton levels above the Newton launch (n = 4k > SMEM_N, k doubling),
    issued by one ``cls_ntt_levels`` call: each level two three-launch
    products, ts = t s stored as 2 - ts by the CRT, then s (2 - ts) reusing
    s's forward rows (``_ROW_STORE_B``, ``_ROW_BHAT``), so its column pass
    transforms 2 - ts alone.  ws: int32, at least 11 rows n_max words."""
    rows, lt = t2.shape
    (k0, _), (k_top, n_top) = levels[0], levels[-1]
    assert 4 * k0 > SMEM_N and k_top == k0 << (len(levels) - 1) and ws.numel() >= 11 * rows * n_top
    out = torch.empty(rows, 2 * k_top, dtype=torch.int64, device=t2.device)
    tables = _k6_tables(tuple(n for _, n in levels), t2.device)
    _build.launch("cls_ntt_levels", t2, s.contiguous(), out, ws, tables, rows, lt, k0, len(levels))
    LAUNCHES["ntt"] += 6 * len(levels)
    return out


def _split_mesh(mesh) -> bool:
    return mesh is not None and mesh.size() > 1


def poly_inv_series_mod_p(
    t: torch.Tensor, out_len: int, *, seed: int | None = None, mesh=None,
    min_shard_n: int = 4096, ws: torch.Tensor | None = None,
) -> torch.Tensor:
    """Power-series inverse of t mod x^out_len (t[0] invertible), Newton;
    ``seed``, if given, is t[0]^-1 mod p, known on the host; with ``mesh``
    the large levels run on the 4-step transform.

    On a CUDA tensor the levels of product length n <= NEWTON_N that no
    mesh shards are one K6 launch (``_k6_newton``); above,
    each level is two three-launch K6 products (``_k6_levels``) in the
    workspace ``ws`` (int32, allocated here if missing or short).  On the
    CPU the same levels run by ``_newton_plain`` and ``poly_mul_mod_p``.
    t: int64 or uint32 words; the series is int64."""
    assert SMEM_N <= NEWTON_N <= NEWTON_MAX_N, NEWTON_N
    t = modp.words(t)
    levels = _inv_levels(out_len)
    lead = t.shape[:-1]
    t2 = _rows(t)
    rows = t2.shape[0]
    s0 = modp.invmod_p(t2[:, :1]) if seed is None else None
    low = _newton_split(levels, t, mesh, min_shard_n, NEWTON_N)
    plain = _plain(t)
    if low and not plain:
        s = _k6_newton(t2, s0, seed, low, max(levels[low - 1][1], 4))
    else:
        s = torch.full((rows, 1), seed, dtype=torch.int64, device=t.device) if s0 is None else s0
        if plain:
            s = _newton_plain(t2, s, levels[:low])
    rest = levels[low:]
    if rest and (plain or _split_mesh(mesh)):
        s = s.reshape(*lead, -1)
        for k, _ in rest:
            ts = poly_mul_mod_p(t[..., : 2 * k], s, out_len=2 * k, mesh=mesh, min_shard_n=min_shard_n)
            s = poly_mul_mod_p(s, _two_minus(ts), out_len=2 * k, mesh=mesh, min_shard_n=min_shard_n)
    elif rest:
        s = _k6_levels(t2, s, rest, _scratch(ws, 11 * rows * rest[-1][1], t.device))
    return s[..., :out_len].reshape(*lead, -1)


def poly_true_degree(x: torch.Tensor) -> int:
    """Index of the highest nonzero coefficient (-1 for the zero poly)."""
    return poly_degree_and_lead(x)[0]


def poly_degree_and_lead(x: torch.Tensor) -> tuple[int, int]:
    """(true degree, its coefficient) of a 1-D polynomial in one read from
    the device; (-1, 0) for the zero polynomial.  x: int64 or uint32 words."""
    x = modp.words(x)
    idx = torch.where(x != 0, torch.arange(x.shape[-1], device=x.device), -1).amax().reshape(1)
    deg, lead = torch.cat([idx, x.index_select(0, idx.clamp(min=0))]).tolist()
    return deg, lead if deg >= 0 else 0


def _div_rev_core(
    num: torch.Tensor, den: torch.Tensor, ql: int, mesh=None, min_shard_n: int = 4096,
    seed: int | None = None,
) -> torch.Tensor:
    """Reversed-series exact division; den's last formal entry nonzero
    (its inverse mod p is ``seed``, if given).  On a CUDA tensor without a
    mesh the series' levels and the quotient's product share one K6
    workspace."""
    nr, dr = torch.flip(num, (-1,))[..., :ql], torch.flip(den, (-1,))
    if _plain(num) or _split_mesh(mesh):
        inv = poly_inv_series_mod_p(dr, ql, seed=seed, mesh=mesh, min_shard_n=min_shard_n)
        qr = poly_mul_mod_p(nr, inv, out_len=ql, mesh=mesh, min_shard_n=min_shard_n)
        return torch.flip(qr, (-1,))
    n = _next_pow2(max(2 * ql - 1, 2))
    above = [ln for _, ln in _inv_levels(ql) if ln > NEWTON_N]
    ws = torch.empty(max([6 * n] + [11 * ln for ln in above]), dtype=torch.int32, device=num.device)
    inv = poly_inv_series_mod_p(dr, ql, seed=seed, ws=ws)
    return torch.flip(_k6_product(nr, inv, n, ws)[..., :ql], (-1,))


def poly_div_exact_mod_p(
    num: torch.Tensor, den: torch.Tensor, quot_len: int, *, den_degree: int | None = None,
    den_lead: int | None = None, mesh=None, min_shard_n: int = 4096,
) -> torch.Tensor:
    """Exact quotient num / den mod p with FLINT true-degree semantics.

    When den's last formal coefficient is zero both operands are shifted
    by x^(ld-1-deg den), so the reversed series inverts a nonzero
    constant.  Returns the low quot_len coefficients of the quotient.
    ``den_degree`` (den's true degree) and ``den_lead`` (its coefficient)
    are read from the device here unless the caller gives them; given
    both, the division moves nothing from the device to the host.  With
    ``mesh`` the large products run on the 4-step transform.  num and den:
    int64 or uint32 words; the quotient is int64.
    """
    assert num.dim() == 1 and den.dim() == 1, "division is single-polynomial"
    num, den = modp.words(num), modp.words(den)
    ln, ld = num.shape[-1], den.shape[-1]
    if den_degree is None:
        den_degree, den_lead = poly_degree_and_lead(den)
    # the reversed series starts at den's leading coefficient in both branches
    seed = None if den_lead is None else pow(den_lead, modp.P - 2, modp.P)
    # den is whole on every rank, so every rank takes the same branch and
    # issues the same collectives
    shift = ld - 1 - den_degree
    if shift == 0:
        return _fit_len(_div_rev_core(num, den, max(ln - ld + 1, 1), mesh, min_shard_n, seed),
                        quot_len)
    num2 = torch.roll(torch.nn.functional.pad(num, (0, ld - 1)), shift)
    den2 = torch.roll(den, shift)
    return _fit_len(_div_rev_core(num2, den2, ln, mesh, min_shard_n, seed), quot_len)
