"""The LWE/SSP SNARK protocol: setup / prover / verifier.

Port of ``c_lwe_snarks_tpu/models/snark.py`` (GMNO18 designated-verifier
zk-SNARK, reference src/snark.c):

* setup: the message schedule (s^i, alpha s^i, beta t(s), beta v_i(s)):
  s^i and alpha s^i from one K9 launch, t(s) and v_i(s) from K8, with no
  host read of s, then all 2d+m
  encryptions as ONE fused keystream->encrypt launch (K4) from CTR_S —
  the four CRS sections are back to back in the stream.
* prover: w, v = v_0 + w and h = (v^2 - 1)/t on the CRT-NTT engine, then
  all five evaluations in ONE fused keystream->MAC sweep (K3) over the
  contiguous CRS term range (the one-pass form), then smudging.  The
  evaluations' epilogue and the five smudges are one K10 launch each.
  ``prover_batch`` proves B statements of one circuit with one polynomial
  stage for all of them (``prover_polys_batch``: t's series inverse made
  once, v^2 and the division over a statement axis) and one sweep for all
  5B evaluations (K3's many-lane form), each proof the bytes ``prover``
  gives: both run the same evaluation-and-smudge body over the statement
  axis (``_evaluate_and_smudge``).
* verifier: the 5 decrypts, t(s) and v_0(s), the mod-p relations and the
  test-error bound in one launch of K11 on the card, with no host sync up
  to the returned bool tensor.

Given a mesh (``parallel.mesh``), setup and the prover split their work
over the ranks: v_i(s) over the rows of v, the encryptions and the five
evaluations over the CRS terms, the NTT's large products over the 4-step
transform; every rank ends with the whole CRS and the whole proof, and
the verifier is unchanged.

All randomness beyond the CRS seed comes from a second seeded AES-CTR
stream ("entropy") in the reference's draw order, so runs are
reproducible and byte-identical to the JAX package given equal seeds.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..ops import digits as dg
from ..ops import modp, ntt, sampling, verify
from ..parallel import mesh as pmesh
from ..parallel.multihost import chunk_bounds
from ..utils.params import Params
from ..utils.spans import span
from . import lwe as tlwe
from . import ssp as tssp


@dataclasses.dataclass
class CRS:
    """seed + compressed ciphertext b-rows (src/snark.h:31-37)."""

    seed: bytes
    b_s: torch.Tensor  # uint8 [d, 88]    Enc(s^i)
    b_as: torch.Tensor  # uint8 [d, 88]   Enc(alpha s^i)
    b_t: torch.Tensor  # uint8 [88]       Enc(beta t(s))
    b_v: torch.Tensor  # uint8 [m-1, 88]  Enc(beta v_i(s)), i in [1, m)


@dataclasses.dataclass
class VRS:
    """Designated-verifier trapdoor (src/snark.h:23-29)."""

    alpha: torch.Tensor  # uint32 scalar < p, as the JAX package's VRSDev holds it
    beta: torch.Tensor
    s: torch.Tensor
    sk: torch.Tensor  # uint8 [n, 88]


@dataclasses.dataclass
class Proof:
    """Five full ciphertexts [n+1, 88] (src/snark.h:14-20)."""

    h: torch.Tensor
    hat_h: torch.Tensor
    hat_v: torch.Tensor
    v_w: torch.Tensor
    b_w: torch.Tensor

    def stack(self) -> torch.Tensor:
        return torch.stack([self.h, self.hat_h, self.hat_v, self.v_w, self.b_w])


# --------------------------------------------------------------------------
# Entropy stream layout (the reference's getrandom call order).
# --------------------------------------------------------------------------


def err_bytes(params: Params) -> int:
    """Bytes per encryption-error draw (errdist_uniform)."""
    return (params.log_sigma + 3) // 8  # 69


def enc_entropy_bytes(params: Params) -> int:
    """Error draw + the dead sign byte per encryption."""
    return err_bytes(params) + 1  # 70


def smudge_entropy_bytes(params: Params) -> int:
    """Smudging draw + sign byte."""
    return params.log_smudging // 8 + 1  # 81


def setup_entropy_bytes(params: Params) -> int:
    """alpha/beta/s (24) + sk (92n) + per-encryption draws."""
    n_enc = 2 * params.d + 1 + (params.m - 1)
    return 24 + params.logq_bytes * params.n + n_enc * enc_entropy_bytes(params)


def prover_entropy_bytes(params: Params) -> int:
    """delta (8) + 5 smudge draws."""
    return 8 + 5 * smudge_entropy_bytes(params)


def _err_digits(ent: sampling.PRGKey, offset: int, count: int, params: Params):
    """count error draws as digit rows [count, 88] (69 live bytes each)."""
    rows = sampling.sample_digit_rows(
        ent, offset, count, draw_bytes=enc_entropy_bytes(params),
        ndigits=err_bytes(params))
    return tlwe.pad_digits(rows)


def setup_errs(
    ent_key: sampling.PRGKey, ent_offset: int, lo: int, hi: int, params: Params
) -> torch.Tensor:
    """Error digit rows [hi - lo, 88] of CRS terms [lo, hi): one 70-byte
    entropy draw a term, in term order, after alpha, beta, s and sk."""
    e_base = ent_offset + 24 + params.logq_bytes * params.n
    return _err_digits(ent_key, e_base + lo * enc_entropy_bytes(params), hi - lo, params)


def setup_messages(
    alpha: torch.Tensor, beta: torch.Tensor, s: torch.Tensor, t: torch.Tensor, v_at_s,
    d: int, m: int,
) -> torch.Tensor:
    """The 2d+m plaintexts in CRS term order: int64 words [2d + m].

    s^i (CTR_S) and alpha s^i (CTR_AS) are one launch of K9's messages form
    into the head of the buffer; t(s) (K8) and v_i(s) = v_at_s(powers) read
    its s^i slice; then beta t(s) (CTR_BT) and beta v_i(s) for i in [1, m)
    (CTR_BV).  Nothing here reads alpha, beta or s on the host."""
    msgs = torch.empty(2 * d + m, dtype=torch.int64, device=s.device)
    modp.message_powers(s, alpha, d, out=msgs[: 2 * d])
    powers = msgs[:d]
    t_s = modp.matvec_mod_p(t[None, :], powers)[0]
    msgs[2 * d] = modp.mulmod_p(beta, t_s)
    msgs[2 * d + 1 :] = modp.mulmod_p(beta, v_at_s(powers)[1:])
    return msgs


# --------------------------------------------------------------------------
# setup
# --------------------------------------------------------------------------


def setup(
    crs_key: sampling.PRGKey,
    ent_key: sampling.PRGKey,
    ent_offset: int,
    ssp: tssp.SSP,
    params: Params,
    *,
    mesh=None,
) -> tuple[CRS, VRS]:
    """CRS/VRS generation (src/snark.c:57-115).

    The 2d+m encryptions are ``lwe.encrypt_section``'s: one fused launch
    (K4) within its signed-sum bound, the scan path past it.  With ``mesh``
    (ssp.v: the rank's rows, ``parallel.mesh.random_ssp_sharded``) each
    rank evaluates its rows of v at s and draws and encrypts its chunk of
    the terms; every rank returns the whole CRS."""
    d, m = params.d, params.m
    n_enc = 2 * d + 1 + (m - 1)
    with span("lwe.setup"):
        if mesh is None:
            v_at_s, (lo, hi) = functools.partial(modp.matvec_mod_p, ssp.v), (0, n_enc)
        else:
            _, rank, world = pmesh.axis(mesh)
            if (ssp.row0, ssp.row0 + ssp.v.shape[0]) != chunk_bounds(m, rank, world):
                raise ValueError(
                    "setup with a mesh takes the rank's rows of v (random_ssp_sharded)")
            v_at_s = functools.partial(pmesh.v_at_s_sharded, ssp.v, mesh=mesh, total=m)
            lo, hi = chunk_bounds(n_enc, rank, world)
        with span("lwe.setup.keys"):
            scalars = modp.bytes_to_u64_mod_p(
                sampling.keystream_bytes(ent_key, ent_offset, 24).reshape(3, 8))
            alpha, beta, s = scalars  # int64 working copies: K9 reads s and alpha on the device
            sk = tlwe.key_gen(ent_key, ent_offset + 24, params)
        with span("lwe.setup.messages"):
            msgs = setup_messages(alpha, beta, s, ssp.t, v_at_s, d, m)
        with span("lwe.setup.encrypt"):
            errs = setup_errs(ent_key, ent_offset, lo, hi, params)
            if mesh is None:
                rows = tlwe.encrypt_section(crs_key, params.ctr_s, sk, msgs, errs, params)
            else:
                rows = pmesh.encrypt_section_sharded(
                    crs_key, params.ctr_s, sk, msgs, errs, params, mesh)
        crs = CRS(seed=crs_key.seed, b_s=rows[:d], b_as=rows[d : 2 * d],
                  b_t=rows[2 * d], b_v=rows[2 * d + 1 :])
        stored = scalars.to(torch.uint32)  # the VRS holds them as the JAX package does
        return crs, VRS(alpha=stored[0], beta=stored[1], s=stored[2], sk=sk)


# --------------------------------------------------------------------------
# prover
# --------------------------------------------------------------------------


def _deltas(ent_key: sampling.PRGKey, offsets: list) -> torch.Tensor:
    """delta of each statement, the 8 stream bytes at its offset mod p:
    int64 [B], from a K1 launch a statement (one statement's draw is not
    copied)."""
    draws = [sampling.keystream_bytes(ent_key, o, 8) for o in offsets]
    return modp.bytes_to_u64_mod_p(torch.stack(draws) if len(draws) > 1 else draws[0][None])


def _prover_polys(ent_key, offsets, ssp, witnesses, params, mesh) -> tuple:
    """The polynomial stage of ``prover_polys`` for the statements of
    ``offsets``, witnesses [*lead, m] with lead () for one statement and
    (B,) for a batch; delta [*lead], w, v and h [*lead, d]."""
    d, m = params.d, params.m
    lead = witnesses.shape[:-1]
    with span("lwe.prover.polys"):
        t = ssp.t.to(torch.int64)
        t_degree, t_lead = ntt.poly_degree_and_lead(t)
        delta = _deltas(ent_key, offsets).reshape(lead)
        if mesh is None:
            rowsums = [modp.gated_rowsum_mod_p(ssp.v[1:], wit[: m - 1])
                       for wit in witnesses.reshape(-1, witnesses.shape[-1])]
            rowsum = torch.stack(rowsums).reshape(*lead, d) if lead else rowsums[0]
            v0 = ssp.v[0]
        else:
            gate = F.pad(witnesses[: m - 1], (1, 0))  # row i gated by bit i-1, v_0 not
            rowsum, v0 = pmesh.gated_rowsum_sharded(ssp, gate, mesh), pmesh.row_zero(ssp, mesh)
        w = modp.addmod_p(modp.mulmod_p(delta[..., None], t), rowsum)
        v = modp.addmod_p(v0.to(torch.int64), w)
        num = ntt.poly_mul_mod_p(v, v, mesh=mesh)
        num[..., 0] = modp.submod_p(num[..., 0], 1)
        # t is whole on every rank of a mesh, so every rank takes the same branch
        # of the division and issues the same collectives
        h = ntt.poly_div_exact_mod_p(num, t, d, den_degree=t_degree, den_lead=t_lead, mesh=mesh)
        return delta, w, v, h


def prover_polys(
    ent_key: sampling.PRGKey,
    ent_offset: int,
    ssp: tssp.SSP,
    witness: torch.Tensor,
    params: Params,
    *,
    mesh=None,
) -> tuple:
    """(delta, w, v, h) of the prover: w = delta * t + sum_{witness bit
    i-1} v_i, v = v_0 + w and h = (v^2 - 1) / t on the CRT-NTT engine.

    With ``mesh`` (ssp.v: the rank's rows) the gated row-sum runs over the
    rank's rows (one int64 ``all_reduce``), v_0 comes from rank 0, and the
    NTT's large products run on the 4-step transform.

    t's true degree and leading coefficient are read from the device once,
    first; after that nothing here moves data to the host (on the card:
    K1 for delta, K7 for the row-sum, K6 for v^2 and the division).  t
    and v_0 are widened to int64 words once each; K7 reads v as it is.
    The one-statement case of ``prover_polys_batch``, with its launches."""
    return _prover_polys(ent_key, [ent_offset], ssp, witness, params, mesh)


def prover_polys_batch(
    ent_key: sampling.PRGKey,
    offsets,
    ssp: tssp.SSP,
    witnesses: torch.Tensor,
    params: Params,
) -> tuple:
    """(delta [B], w, v, h [B, d]) of B statements of one circuit, one an
    (entropy offset, witness) pair: row j is byte for byte
    ``prover_polys(ent_key, offsets[j], ssp, witnesses[j], params)``.

    Each step runs once for the batch: t's degree and lead read once (as in
    ``prover_polys``), one reduction of the B deltas (``_deltas``), w and v
    as [B, d] ops, v^2 as one K6 product over the B rows, and the division
    with t's series inverse made once (one Newton launch and the levels
    above it) and one quotient product; only the deltas' draws (K1) and the
    row-sums (K7) are a launch a statement.  witnesses: uint8 bits [B, m]."""
    offsets = list(offsets)
    if not offsets or witnesses.dim() != 2 or witnesses.shape[0] != len(offsets):
        raise ValueError(f"{len(offsets)} offsets for witnesses {tuple(witnesses.shape)}")
    return _prover_polys(ent_key, offsets, ssp, witnesses, params, None)


def onepass_terms(
    crs: CRS,
    w: torch.Tensor,
    h: torch.Tensor,
    v: torch.Tensor,
    delta: torch.Tensor,
    witness: torch.Tensor,
    params: Params,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(b-rows uint8 [2d+m, 88], coefficients int64 [5B, 2d+m]) of the one
    sweep over every CRS term for B proofs: w, h, v [B, d], delta [B] and
    witness [B, m], or one proof's without the batch axis (B = 1).

    The CRS sections are back to back in the stream, so (w, h over s),
    (v, h over as) and b_w (delta at the bt term + witness bits over bv)
    are five coefficient lanes over the same contiguous term range, each
    lane zero outside its section; lane t B + j is lane t of proof j
    (``onepass_sections``)."""
    d, m = params.d, params.m
    w, h, v = (x.reshape(-1, d) for x in (w, h, v))
    b = w.shape[0]
    coeffs = torch.zeros(5, b, 2 * d + m, dtype=torch.int64, device=w.device)
    coeffs[0, :, :d] = w
    coeffs[1, :, :d] = h
    coeffs[2, :, d : 2 * d] = v
    coeffs[3, :, d : 2 * d] = h
    coeffs[4, :, 2 * d] = delta.reshape(b)
    coeffs[4, :, 2 * d + 1 :] = witness.reshape(b, m)[:, : m - 1].to(torch.int64)
    b_all = torch.cat([crs.b_s, crs.b_as, crs.b_t[None], crs.b_v])
    return b_all, coeffs.reshape(5 * b, 2 * d + m)


def onepass_sections(params: Params, batch: int = 1) -> tuple:
    """The lanes of ``onepass_terms``'s B = ``batch`` proofs that each CRS
    section reads, as ``eval_fused.eval_mac_planes``'s sections: (w, h) of
    every proof over s, (v, h) over as, b_w over bt and bv."""
    d, m, b = params.d, params.m, batch
    return ((0, d, 0, 2 * b), (d, 2 * d, 2 * b, 4 * b), (2 * d, 2 * d + m, 4 * b, 5 * b))


def _evaluate_and_smudge(
    crs_key: sampling.PRGKey,
    ent_key: sampling.PRGKey,
    offsets: list,
    crs: CRS,
    delta: torch.Tensor,
    w: torch.Tensor,
    v: torch.Tensor,
    h: torch.Tensor,
    witnesses: torch.Tensor,
    params: Params,
    mesh=None,
) -> list[Proof]:
    """The proofs of the B statements of ``offsets`` from their polynomial
    stage (delta [B], w, v, h [B, d], witnesses [B, m], or one statement's
    without the batch axis): all 5B evaluations in ONE keystream sweep
    (``onepass_terms``; K3's form of 8 lanes at B = 1, its many-lane form
    past it, each CRS section reading only its own lanes,
    ``onepass_sections``), the b-row MAC and one K10 fold, then each proof
    smudged from its own offset (``smudge_proof``).  With ``mesh`` (B = 1
    only), one K3 launch a rank over its chunk of the terms and one
    ``all_reduce``."""
    b, n = len(offsets), params.n
    if mesh is not None and b != 1:
        raise ValueError(f"the sharded sweep proves one statement, got {b}")
    with span("lwe.prover.evals"):
        b_all, coeffs = onepass_terms(crs, w, h, v, delta, witnesses, params)
        if mesh is None:
            evals = tlwe.eval_poly_multi(crs_key, params.ctr_s, b_all, coeffs, params,
                                         sections=onepass_sections(params, b))
        else:
            evals = pmesh.eval_poly_multi_sharded(
                crs_key, params.ctr_s, b_all, coeffs, params, mesh)
        # lane t B + j -> proof j's evaluation t, each proof's five contiguous
        # (already so at B = 1: no copy)
        evals = evals.reshape(5, b, n + 1, tlwe.DIGITS).transpose(0, 1).contiguous()
    return [smudge_proof(ent_key, off, evals[j], params) for j, off in enumerate(offsets)]


def prover(
    crs_key: sampling.PRGKey,
    ent_key: sampling.PRGKey,
    ent_offset: int,
    crs: CRS,
    ssp: tssp.SSP,
    witness: torch.Tensor,
    params: Params,
    *,
    mesh=None,
) -> Proof:
    """src/snark.c:117-190; witness: uint8 bits [m] (bit i-1 gates v_i).

    ``prover_polys``, then the five evaluations in one kernel sweep and
    the smudging (``_evaluate_and_smudge``).  With ``mesh`` (ssp.v: the
    rank's rows) the work splits over the ranks as ``prover_polys`` and
    the sweep say; every rank returns the whole proof."""
    with span("lwe.prover"):
        # through the module's name, so that a wrapper put there sees the call
        delta, w, v, h = prover_polys(ent_key, ent_offset, ssp, witness, params, mesh=mesh)
        return _evaluate_and_smudge(crs_key, ent_key, [ent_offset], crs, delta, w, v, h,
                                    witness, params, mesh)[0]


def prover_batch(
    crs_key: sampling.PRGKey,
    ent_key: sampling.PRGKey,
    offsets,
    crs: CRS,
    ssp: tssp.SSP,
    witnesses,
    params: Params,
) -> list[Proof]:
    """Proofs of B statements of one circuit, one a (entropy offset,
    witness) pair, in the order of ``offsets``: proof j is byte for byte
    ``prover(crs_key, ent_key, offsets[j], crs, ssp, witnesses[j], params)``.

    The statements' (delta, w, v, h) come from one call of
    ``prover_polys_batch``; then all 5B evaluations are one keystream sweep
    and each proof is smudged from its own offset (``_evaluate_and_smudge``,
    the body ``prover`` runs).  witnesses: uint8 bits [m] each, on the
    CRS's device."""
    offsets, witnesses = list(offsets), list(witnesses)
    if len(offsets) != len(witnesses):
        raise ValueError(f"{len(offsets)} offsets for {len(witnesses)} witnesses")
    if not offsets:
        return []
    with span("lwe.prover_batch"):
        wits = torch.stack(witnesses)
        # through the module's name, so that a wrapper put there sees the call
        delta, w, v, h = prover_polys_batch(ent_key, offsets, ssp, wits, params)
        return _evaluate_and_smudge(crs_key, ent_key, offsets, crs, delta, w, v, h, wits, params)


# the evaluation each smudging draw lands on, in draw order h, hat_h, hat_v,
# v_w, v_w (evaluations in the order v_w, h, hat_v, hat_h, b_w)
SMUDGE_TARGETS = (1, 3, 2, 0, 0)


def smudge_proof(ent_key: sampling.PRGKey, ent_offset: int, evals, params: Params) -> Proof:
    """The proof from the five evaluations (v_w, h, hat_v, hat_h, b_w):
    smudging in the reference order h, hat_h, hat_v, v_w, v_w (v_w twice,
    b_w never — src/snark.c:184-189), drawn after delta.

    evals: uint8 [5, n+1, 88], whose b rows are smudged in place; on the
    card all five draws are one launch of K10's smudge form, the signs
    read on the device."""
    with span("lwe.prover.smudge"):
        draws = sampling.sample_digit_rows(
            ent_key, ent_offset + 8, 5, draw_bytes=smudge_entropy_bytes(params),
            ndigits=smudge_entropy_bytes(params))  # 80 digit bytes, then the sign byte
        dg.smudge_draws(evals, draws, SMUDGE_TARGETS)
        v_w, h_ct, hat_v, hat_h, b_w = evals
        return Proof(h=h_ct, hat_h=hat_h, hat_v=hat_v, v_w=v_w, b_w=b_w)


# --------------------------------------------------------------------------
# verifier
# --------------------------------------------------------------------------


def test_error_ok(vrs: VRS, proof: Proof, params: Params) -> torch.Tensor:
    """The reference verifier's "test-error" bound (src/snark.c:237-241).

    The signed limb count of -floor(dot / p) is derived from 11 threshold
    comparisons; it is always below log_smudging/8 at these parameters,
    but computed literally (``ops.verify.error_count_plain``; on the card
    the verifier counts it inside K11).
    """
    return -verify.error_count_plain(proof.b_w, vrs.sk) < params.log_smudging // 8


def verifier(vrs: VRS, ssp: tssp.SSP, proof: Proof, params: Params) -> torch.Tensor:
    """Decrypt the proof and check the mod-p relations and the test-error
    bound; bool scalar.

    On the card one launch of K11's verifier form (``ops.verify.verify``):
    the five decrypts, t(s) and v_0(s), the relations and the bound, the
    verdict a device bool with no host sync; on the CPU its plain version.
    Reads t and v_0 of the SSP (a rank's rows of v hold v_0 on rank 0
    only: ``parallel.mesh.row_zero``)."""
    with span("lwe.verifier"):
        if ssp.row0:
            raise ValueError("the verifier needs v_0; this SSP holds rows from row0 on")
        cts = (proof.h, proof.hat_h, proof.hat_v, proof.v_w, proof.b_w)
        ok, _ = verify.verify(cts, vrs.sk, ssp.t, ssp.v[0], vrs.s, vrs.alpha, vrs.beta,
                              params.log_smudging // 8)
        return ok
