"""The lattice SNARK (GMNO18: Regev LWE over square span programs), written
plainly in torch and Python integers, as the benchmark's reference.

It derives from the two 40-byte seeds alone, in the stream layout of the C
reference (mangiafuoco, src/snark.c, src/ssp.c, src/lwe.c), everything the
program derives: the circuit (the witness, v and t), the CRS's b rows, the
VRS and the proofs, and it judges a proof as the designated verifier does.
It takes nothing that the program has made.

* Arithmetic mod p = 2^32 - 5 is int64 tensors (a product split at 16 bits
  so that it stays below 2^63), and a sum of digit products is a float64
  matrix product whose every partial sum is an integer below 2^53.
* Ciphertexts live mod 2^(8 D) with D = q_bits / 8 digits: 704 bits as the
  reference's ``modq`` truncates log q = 736; a smaller ``q_bits`` is the
  control's lower precision, the same arithmetic with fewer digits.
* A proof is the five evaluations sum_j c_j (a_j, b_j) of the CRS terms.  The
  a-part is summed from the regenerated stream; the b-part uses that
  b_j = <sk, a_j> + p e_j + m_j, so sum_j c_j b_j = <sk, A> + p E + M with A,
  E and M the same sums of a_j, e_j and m_j.  It needs no b row of the CRS.
* The quotient h = (v^2 - 1) / t: random_ssp's instance is satisfied by
  construction (t = v_0 + sum of the witness's rows - 1), so v = (1 + delta) t
  + 1 and h = (1 + delta)^2 t + 2 (1 + delta).  A statement of
  ``statement_circuits`` has v_0 + its gated rows = c t + 1 with its own
  scale c, so v = (c + delta) t + 1 and h = (c + delta)^2 t + 2 (c + delta).
  The reference takes h in that form and checks h t = v^2 - 1 at eight
  points it draws, so a quotient that is not exact raises.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .aes import Stream

STORED = 92  # bytes a stored digit row takes (LOGQ_BYTES)
THRESHOLD_LIMBS = 11  # the test-error bound's thresholds p * 2^(64 j), j < 11
TERM_CHUNK = 1024  # CRS terms a pass of the stream takes at once
ROW_CHUNK_BLOCKS = 1 << 23  # stream blocks a chunk of v's rows takes


@dataclasses.dataclass(frozen=True)
class Params:
    """The configuration's numbers (the C reference's GAMMA_* macros)."""

    d: int
    m: int
    n: int
    logq: int = 736
    p: int = (1 << 32) - 5
    log_smudging: int = 640
    log_sigma: int = 556
    q_bits: int = 704  # the ring the ciphertexts live in: logq truncated to whole limbs

    @classmethod
    def from_config(cls, cfg: dict, q_bits: int | None = None) -> "Params":
        keys = ("d", "m", "n", "logq", "p", "log_smudging", "log_sigma")
        P = cls(**{k: int(cfg[k]) for k in keys})
        return P if q_bits is None else dataclasses.replace(P, q_bits=q_bits)

    def __post_init__(self):
        if self.logq // 64 * 64 < self.q_bits or self.q_bits % 64 or self.d % 2:
            raise ValueError(f"unsupported parameters {self}")

    @property
    def digits(self) -> int:
        return self.q_bits // 8

    @property
    def ctr_ct(self) -> int:  # stream bytes one ciphertext's a-vector takes
        return STORED * self.n

    @property
    def terms(self) -> int:  # CRS terms: s^i, alpha s^i, beta t(s), beta v_i(s) for i >= 1
        return 2 * self.d + self.m

    @property
    def err_bytes(self) -> int:
        return (self.log_sigma + 3) // 8

    @property
    def smudge_bytes(self) -> int:  # the digits and a sign byte
        return self.log_smudging // 8 + 1

    @property
    def witness_bytes(self) -> int:
        return self.m // 8

    @property
    def v_block0(self) -> int:  # the stream block where v_0 starts
        return (self.witness_bytes + (-self.witness_bytes) % 16) // 16

    @property
    def off_setup(self) -> int:
        return 16 * self.v_block0 + 8 * self.m * self.d

    @property
    def off_prove(self) -> int:
        return self.off_setup + 24 + STORED * self.n + self.terms * (self.err_bytes + 1)

    @property
    def prove_entropy(self) -> int:  # delta, then five smudging draws
        return 8 + 5 * self.smudge_bytes

    def prove_offset(self, i: int) -> int:
        """Where the entropy of the circuit's i-th proof starts: the proofs'
        draws follow setup's, one after another."""
        return self.off_prove + i * self.prove_entropy


# --------------------------------------------------------------------------
# Arithmetic
# --------------------------------------------------------------------------


def mulmod(a: torch.Tensor, b, p: int) -> torch.Tensor:
    """a * b mod p for int64 a, b in [0, p), p < 2^32."""
    hi = (a * (b >> 16)) % p
    return ((hi << 16) + a * (b & 0xFFFF)) % p


def powers(s: int, count: int, p: int, device) -> torch.Tensor:
    """int64 [count]: s^i mod p."""
    out = torch.ones(count, dtype=torch.int64, device=device)
    k, sk = 1, s % p
    while k < count:
        width = min(k, count - k)
        out[k : k + width] = mulmod(out[:width], sk, p)
        k, sk = 2 * k, sk * sk % p
    return out


def poly_at(coeffs: torch.Tensor, pw: torch.Tensor, p: int) -> torch.Tensor:
    """Polynomials int64 [..., d] at the point whose powers are pw [d]: mod p."""
    return mulmod(coeffs, pw, p).sum(-1) % p


def u64_mod_p(raw: bytes, p: int) -> int:
    return int.from_bytes(raw, "little") % p


def carry(sums: torch.Tensor, digits: int) -> torch.Tensor:
    """Non-negative int64 digit sums [..., L] -> their value mod 256^digits as
    uint8 digits [..., digits]."""
    out = torch.zeros(*sums.shape[:-1], digits, dtype=torch.uint8, device=sums.device)
    c = torch.zeros(sums.shape[:-1], dtype=torch.int64, device=sums.device)
    for k in range(digits):
        x = c + sums[..., k] if k < sums.shape[-1] else c
        out[..., k] = (x & 0xFF).to(torch.uint8)
        c = x >> 8
    return out


def sums_to_int(sums) -> int:
    """Digit sums (any iterable of ints, position k weighing 256^k) -> int."""
    return sum(int(x) << (8 * k) for k, x in enumerate(sums))


def int_to_row(x: int, P: Params) -> bytes:
    """A value mod 2^q_bits as its stored row: the digits, then zeros to 92."""
    return (x % (1 << P.q_bits)).to_bytes(P.digits, "little") + bytes(STORED - P.digits)


def toeplitz(sk: torch.Tensor, digits: int) -> torch.Tensor:
    """float64 [n * D, D] with row (x, u), column k holding sk[x, k - u] (0 for
    k < u): a [.., n * D] @ it gives the digit sums of <a, sk> below 256^D."""
    u = torch.arange(digits, device=sk.device)
    k = u[None, :] - u[:, None]
    mat = sk[:, :digits].to(torch.float64)[:, k.clamp(min=0)] * (k >= 0)
    return mat.reshape(-1, digits)


# --------------------------------------------------------------------------
# The circuit, the VRS and the errors
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Circuit:
    """random_ssp's witness and instance, as far as the reference derived it."""

    wits: torch.Tensor  # uint8 bits [m]
    t: torch.Tensor  # int64 [d]
    v0: torch.Tensor  # int64 [d]
    rowsum: torch.Tensor  # int64 [d]: sum of v_i over the witness's bits, i >= 1
    v_at_s: torch.Tensor  # int64 [m]: v_i(s), -1 for a row not derived
    v: torch.Tensor | None = None  # int64 [m, d], kept when asked
    scale: int = 1  # c in v_0 + rowsum = c t + 1


def witness_bits(ent: Stream, P: Params) -> torch.Tensor:
    raw = ent.bytes(0, P.witness_bytes)
    bits = torch.zeros(P.m, dtype=torch.uint8, device=ent.device)
    shifts = torch.arange(8, device=ent.device, dtype=torch.uint8)
    bits[: 8 * raw.numel()] = ((raw[:, None] >> shifts) & 1).reshape(-1)
    return bits


def v_rows(ent: Stream, P: Params, rows: torch.Tensor) -> torch.Tensor:
    """int64 [R, d]: rows of v, each d draws of 8 stream bytes mod p."""
    half = P.d // 2
    ctr = P.v_block0 + rows[:, None] * half + torch.arange(half, device=rows.device)[None]
    words = ent.blocks(ctr.reshape(-1)).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    words = words.reshape(-1, 2, 2)  # [block, draw, (lo, hi)]
    return ((words[..., 1] * 5 + words[..., 0]) % P.p).reshape(rows.numel(), P.d)


def circuit(ent: Stream, P: Params, s: int, *, every_row: bool, keep_v: bool = False) -> Circuit:
    """The circuit of the entropy stream: the rows the witness gates (and v_0),
    or with ``every_row`` all m rows, each evaluated at s."""
    dev = ent.device
    wits = witness_bits(ent, P)
    gate = torch.cat([torch.ones(1, dtype=torch.uint8, device=dev), wits[: P.m - 1]])
    rows = torch.arange(P.m, device=dev) if every_row else torch.nonzero(gate)[:, 0]
    pw = powers(s, P.d, P.p, dev)
    gated = torch.zeros(P.d, dtype=torch.int64, device=dev)
    v_at_s = torch.full((P.m,), -1, dtype=torch.int64, device=dev)
    v = torch.zeros(P.m, P.d, dtype=torch.int64, device=dev) if keep_v else None
    step = max(1, ROW_CHUNK_BLOCKS // (P.d // 2))
    v0 = None
    for lo in range(0, rows.numel(), step):
        idx = rows[lo : lo + step]
        block = v_rows(ent, P, idx)
        gated = (gated + (block * gate[idx, None]).sum(0)) % P.p
        v_at_s[idx] = poly_at(block, pw, P.p)
        if v0 is None:
            v0 = block[0].clone()  # every derivation starts at row 0
        if keep_v:
            v[idx] = block
    t = gated.clone()
    t[0] = (t[0] - 1) % P.p
    return Circuit(wits=wits, t=t, v0=v0, rowsum=(gated - v0) % P.p, v_at_s=v_at_s, v=v)


def statement_circuits(ent: Stream, P: Params, s: int, others: list[torch.Tensor],
                       pivots: list[int], *, keep_v: bool = False) -> list[Circuit]:
    """The circuits of W = len(others) + 1 statements of one instance, every
    row derived and evaluated at s.  Statement 0 is random_ssp's witness, and
    t stays random_ssp's.  Statement b >= 1 has the witness bits others[b - 1]
    (uint8 [m]) with the gating bit of every pivot row (rows ``pivots``, none
    of them gated by statement 0) cleared but its own, pivots[b - 1]'s, set;
    that row of v is replaced by (1 + b) t + 1 - v_0 - (the other rows
    statement b gates), so v_0 plus the rows statement b gates is
    (1 + b) t + 1 (``Circuit.scale``).  The circuits share t, v_0, every
    v_i(s) and, with ``keep_v``, v."""
    dev, p, W = ent.device, P.p, len(others) + 1
    piv = torch.tensor(pivots, dtype=torch.int64, device=dev)
    bits = torch.stack([witness_bits(ent, P), *others])
    if bool(bits[0, piv - 1].any()):
        raise ValueError("statement 0 gates a pivot row")
    bits[1:, piv - 1] = 0
    bits[torch.arange(1, W, device=dev), piv - 1] = 1
    free = torch.cat([torch.zeros(W, 1, dtype=torch.float64, device=dev),
                      bits[:, : P.m - 1].to(torch.float64)], 1)  # row i's gate, v_0's apart
    free[:, piv] = 0
    pw = powers(s, P.d, p, dev)
    sums = torch.zeros(W, P.d, dtype=torch.int64, device=dev)  # the non-pivot gated rows i >= 1
    v_at_s = torch.empty(P.m, dtype=torch.int64, device=dev)
    v = torch.zeros(P.m, P.d, dtype=torch.int64, device=dev) if keep_v else None
    step = max(1, ROW_CHUNK_BLOCKS // (P.d // 2))
    v0 = None
    for lo in range(0, P.m, step):
        idx = torch.arange(lo, min(P.m, lo + step), device=dev)
        block = v_rows(ent, P, idx)
        # 0/1 times words < 2^32, summed over fewer than 2^21 rows: exact in float64
        sums = (sums + (free[:, idx] @ block.to(torch.float64)).to(torch.int64)) % p
        v_at_s[idx] = poly_at(block, pw, p)
        if v0 is None:
            v0 = block[0].clone()
        if keep_v:
            v[idx] = block
    t = (v0 + sums[0]) % p
    t[0] = (t[0] - 1) % p
    out = [Circuit(wits=bits[0], t=t, v0=v0, rowsum=sums[0], v_at_s=v_at_s, v=v)]
    for b in range(1, W):
        rowsum = mulmod(t, 1 + b, p)
        rowsum[0] = (rowsum[0] + 1) % p
        rowsum = (rowsum - v0) % p
        row = (rowsum - sums[b]) % p
        v_at_s[pivots[b - 1]] = poly_at(row, pw, p)
        if keep_v:
            v[pivots[b - 1]] = row
        out.append(Circuit(wits=bits[b], t=t, v0=v0, rowsum=rowsum, v_at_s=v_at_s, v=v,
                           scale=1 + b))
    return out


@dataclasses.dataclass
class VRS:
    alpha: int
    beta: int
    s: int
    sk: torch.Tensor  # uint8 [n, 88]


def vrs(ent: Stream, P: Params) -> VRS:
    raw = bytes(ent.bytes(P.off_setup, 24).cpu().numpy())
    alpha, beta, s = (u64_mod_p(raw[8 * i : 8 * i + 8], P.p) for i in range(3))
    sk = ent.bytes(P.off_setup + 24, STORED * P.n).reshape(P.n, STORED)[:, :88]
    return VRS(alpha, beta, s, sk.contiguous())


def errors(ent: Stream, P: Params) -> torch.Tensor:
    """uint8 [terms, err_bytes]: each term's error draw (its sign byte dropped)."""
    base = P.off_setup + 24 + STORED * P.n
    draw = P.err_bytes + 1
    return ent.bytes(base, P.terms * draw).reshape(P.terms, draw)[:, : P.err_bytes]


def messages(circ: Circuit, key: VRS, P: Params) -> torch.Tensor:
    """int64 [terms]: s^i, alpha s^i, beta t(s), beta v_i(s) (i >= 1) mod p;
    -1 where v_i(s) was not derived."""
    dev = circ.t.device
    pw = powers(key.s, P.d, P.p, dev)
    t_s = int(poly_at(circ.t, pw, P.p))
    bv = circ.v_at_s[1:]
    bv = torch.where(bv >= 0, mulmod(bv.clamp(min=0), key.beta, P.p), -1)
    return torch.cat([pw, mulmod(pw, key.alpha, P.p),
                      torch.tensor([key.beta * t_s % P.p], device=dev), bv])


# --------------------------------------------------------------------------
# The sweep over the CRS terms' a-vectors
# --------------------------------------------------------------------------


def _byte_planes(coeffs: torch.Tensor) -> torch.Tensor:
    """int64 [L, terms] words < 2^32 -> [4 L, terms], row 4 l + b byte b."""
    shifts = torch.arange(4, device=coeffs.device) * 8
    return ((coeffs[:, None, :] >> shifts[None, :, None]) & 0xFF).reshape(-1, coeffs.shape[1])


def sweep(crs: Stream, P: Params, coeffs: torch.Tensor | None = None,
          sk: torch.Tensor | None = None):
    """One pass over the a-vectors of all CRS terms, regenerated from the
    CRS stream.  Returns (A, dots): A uint8 [L, n, D], the sums sum_j
    coeffs[l, j] a_j mod 2^(8 D) (coeffs int64 [L, terms]); dots int64
    [terms, D], each term's digit sums of <a_j, sk>.  Either may be None."""
    D, n, dev = P.digits, P.n, crs.device
    planes = None if coeffs is None else _byte_planes(coeffs).to(torch.float64)
    acc = None if coeffs is None else torch.zeros(planes.shape[0], n * D, dtype=torch.float64,
                                                  device=dev)
    mat = None if sk is None else toeplitz(sk, D)
    dots = None if sk is None else torch.empty(P.terms, D, dtype=torch.int64, device=dev)
    for lo in range(0, P.terms, TERM_CHUNK):
        hi = min(P.terms, lo + TERM_CHUNK)
        raw = crs.bytes(lo * P.ctr_ct, (hi - lo) * P.ctr_ct).reshape(hi - lo, n, STORED)
        a = raw[:, :, :D].reshape(hi - lo, n * D).to(torch.float64)
        if acc is not None:
            acc += planes[:, lo:hi] @ a  # every partial sum < 2^18 * 255^2
        if mat is not None:
            dots[lo:hi] = (a @ mat).to(torch.int64)  # each < n * D * 255^2
    A = None
    if acc is not None:
        acc = acc.to(torch.int64).reshape(-1, 4, n, D)
        sums = torch.zeros(acc.shape[0], n, D + 3, dtype=torch.int64, device=dev)
        for b in range(4):
            sums[..., b : b + D] += acc[:, b]
        A = carry(sums, D)
    return A, dots


def dot_int(a: torch.Tensor, mat: torch.Tensor, P: Params) -> int:
    """<a, sk> mod 2^(8 D) for a uint8 [n, >= D] (mat = toeplitz(sk, D))."""
    sums = (a[:, : P.digits].reshape(1, -1).to(torch.float64) @ mat).to(torch.int64)[0]
    return sums_to_int(sums.tolist()) % (1 << P.q_bits)


# --------------------------------------------------------------------------
# setup, prover, verifier
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Setup:
    """What a circuit's set-up publishes, derived again."""

    t: torch.Tensor  # int64 [d]
    crs: bytes
    vrs: bytes
    circuit: Circuit
    key: VRS


def vrs_bytes(key: VRS, P: Params) -> bytes:
    """alpha, beta, s as 8-byte words, then sk's rows mod 2^q_bits, stored."""
    head = b"".join(x.to_bytes(8, "little") for x in (key.alpha, key.beta, key.s))
    sk = torch.nn.functional.pad(key.sk[:, : P.digits], (0, STORED - P.digits)).cpu().numpy()
    return head + sk.tobytes()


def setup(crs: Stream, ent: Stream, P: Params, *, keep_v: bool = False) -> Setup:
    """random_ssp, then setup: t, the CRS (seed and b rows) and the VRS."""
    key = vrs(ent, P)
    circ = circuit(ent, P, key.s, every_row=True, keep_v=keep_v)
    msgs = messages(circ, key, P)
    _, dots = sweep(crs, P, sk=key.sk)
    e = errors(ent, P).to(torch.int64)
    sums = torch.zeros(P.terms, P.digits + 4, dtype=torch.int64, device=ent.device)
    sums[:, : P.digits] = dots
    for b, pb in enumerate(P.p.to_bytes(4, "little")):  # p * e_j
        sums[:, b : b + e.shape[1]] += pb * e
    for b in range(4):  # + m_j
        sums[:, b] += (msgs >> (8 * b)) & 0xFF
    rows = torch.nn.functional.pad(carry(sums, P.digits), (0, STORED - P.digits))
    blob = crs.seed + rows.cpu().numpy().tobytes()
    return Setup(t=circ.t, crs=blob, vrs=vrs_bytes(key, P), circuit=circ, key=key)


def _points(seed: bytes, count: int, p: int) -> list[int]:
    h = hashlib.sha256(b"portbench reference points" + seed).digest()
    return [int.from_bytes(hashlib.sha256(h + bytes([i])).digest()[:8], "little") % p
            for i in range(count)]


def prover_coeffs(ent: Stream, P: Params, circ: Circuit, offset: int) -> torch.Tensor:
    """int64 [5, terms]: the five evaluations' coefficients of the proof whose
    entropy starts at ``offset``, in the order v_w, h, hat_v, hat_h, b_w."""
    p, d, dev = P.p, P.d, ent.device
    delta = u64_mod_p(bytes(ent.bytes(offset, 8).cpu().numpy()), p)
    w = (mulmod(circ.t, delta, p) + circ.rowsum) % p
    v = (circ.v0 + w) % p
    c = (circ.scale + delta) % p  # v = c t + 1
    h = mulmod(circ.t, c * c % p, p)
    h[0] = (h[0] + 2 * c) % p
    for r in _points(ent.seed + offset.to_bytes(8, "little"), 8, p):
        pw = powers(r, d, p, dev)
        h_r, t_r, v_r = (int(poly_at(x, pw, p)) for x in (h, circ.t, v))
        if h_r * t_r % p != (v_r * v_r - 1) % p:
            raise ArithmeticError("h t != v^2 - 1: the instance is not random_ssp's")
    c = torch.zeros(5, P.terms, dtype=torch.int64, device=dev)
    c[0, :d], c[1, :d], c[2, d : 2 * d], c[3, d : 2 * d] = w, h, v, h
    c[4, 2 * d] = delta
    c[4, 2 * d + 1 :] = circ.wits[: P.m - 1].to(torch.int64)
    return c


# the evaluation each smudging draw lands on (draw order h, hat_h, hat_v,
# v_w, v_w; evaluations v_w, h, hat_v, hat_h, b_w), and the proof's order
SMUDGE_TARGETS = (1, 3, 2, 0, 0)
PROOF_ORDER = (1, 3, 2, 0, 4)


def proofs(crs: Stream, ent: Stream, P: Params, circ: Circuit | list[Circuit], key: VRS,
           offsets: list[int]) -> list[bytes]:
    """The proof bytes (h, hat_h, hat_v, v_w, b_w; each n + 1 stored rows) of
    the circuit, or of one circuit a proof (statements of one instance, which
    share t and every v_i(s)), for each prover entropy offset, from one sweep."""
    circs = circ if isinstance(circ, list) else [circ] * len(offsets)
    coeffs = torch.cat([prover_coeffs(ent, P, c, off) for c, off in zip(circs, offsets)])
    msgs = messages(circs[0], key, P)
    if bool(((coeffs != 0) & (msgs < 0)).any()):
        raise ValueError("a proof needs v_i(s) of a row the circuit did not derive")
    A, _ = sweep(crs, P, coeffs=coeffs)
    mat = toeplitz(key.sk, P.digits)
    planes = _byte_planes(coeffs)
    e_sums = (planes.to(torch.float64) @ errors(ent, P).to(torch.float64)).to(torch.int64)
    m_sums = (planes * msgs.clamp(min=0)).sum(1)  # each < 2^40 * terms
    out = []
    for k, off in enumerate(offsets):
        bs = []
        for lane in range(5):
            r = 5 * k + lane
            E = sum(sums_to_int(e_sums[4 * r + b].tolist()) << (8 * b) for b in range(4))
            M = sum(int(m_sums[4 * r + b]) << (8 * b) for b in range(4))
            bs.append((dot_int(A[r], mat, P) + P.p * E + M) % (1 << P.q_bits))
        draws = bytes(ent.bytes(off + 8, 5 * P.smudge_bytes).cpu().numpy())
        for i, target in enumerate(SMUDGE_TARGETS):
            draw = draws[i * P.smudge_bytes : (i + 1) * P.smudge_bytes]
            s = int.from_bytes(draw[:-1], "little") * P.p
            bs[target] = (bs[target] + (s if draw[-1] & 1 == 0 else -s)) % (1 << P.q_bits)
        a_rows = torch.nn.functional.pad(A[5 * k : 5 * k + 5], (0, STORED - P.digits)).cpu()
        blob = b"".join(a_rows[lane].numpy().tobytes() + int_to_row(bs[lane], P)
                        for lane in PROOF_ORDER)
        out.append(blob)
    return out


def verify(proof: bytes, key: VRS, t: torch.Tensor, v0: torch.Tensor, P: Params) -> bool:
    """The designated verifier's verdict on proof bytes: the five decrypts,
    each side taken mod p (b mod p minus <a, sk> mod 2^(8 D) mod p), the
    relations mod p and the test-error bound."""
    p, n, D = P.p, P.n, P.digits
    cts = torch.tensor(np.frombuffer(proof, dtype=np.uint8).reshape(5, n + 1, STORED),
                       device=key.sk.device)
    mat = toeplitz(key.sk, D)
    dots = [dot_int(cts[i, :n], mat, P) for i in range(5)]
    bvals = [int.from_bytes(bytes(cts[i, n, :D].cpu().numpy()), "little") for i in range(5)]
    h, hat_h, hat_v, v_w, b_w = ((b % p - x % p) % p for b, x in zip(bvals, dots))
    pw = powers(key.s, P.d, p, key.sk.device)
    t_s, v0_s = int(poly_at(t, pw, p)), int(poly_at(v0, pw, p))
    v_s = (v0_s + v_w) % p
    count = sum(p << (64 * j) <= dots[4] for j in range(THRESHOLD_LIMBS))
    return (h * key.alpha % p == hat_h and v_s * key.alpha % p == hat_v
            and (v_s * v_s - 1 - h * t_s) % p == 0 and v_w * key.beta % p == b_w
            and -count < P.log_smudging // 8)


def ssp_bytes(circ: Circuit) -> bytes:
    """The SSP buffer: t, then v_0 .. v_{m-1}, each d uint64-LE words (needs
    a circuit derived with every row and ``keep_v``)."""
    return (circ.t.cpu().numpy().astype("<u8").tobytes()
            + circ.v.cpu().numpy().astype("<u8").tobytes())
