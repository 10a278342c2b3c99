"""Entry ``verify``: one verdict a request, on proofs taken in turn from a pool.

Set-up makes one circuit and its CRS and VRS on the device from the run's
seeds, ``honest`` proofs of it (each from its own entropy) with the
program's prover, and ``tampered`` copies of them, each with one byte of one
ciphertext flipped, half in its b row and half in an a row.  The requests
cycle through a seeded order in which one in ``tamper_every`` is tampered.
Request i reads the proof's bytes (``serial.proof_from_bytes``), runs
``snark.verifier`` and ends with the verdict on the host.  The check derives
the honest proofs again with the plain reference, tampers them alike, and
compares the pool's bytes and every verdict of the window with the
reference verifier's.
"""

from __future__ import annotations

import sys
import time

from portbench.checks import differing
from portbench.reference import protocol as ref
from portbench.reference.aes import Stream


def _plan(ctx, n: int) -> tuple:
    """(tampers [(honest proof, byte offset, xor)], the request order over the
    pool: honest entries 0..H-1, then the tampered ones)."""
    tr = ctx.traffic
    honest, tampered, every = int(tr["honest"]), int(tr["tampered"]), int(tr["tamper_every"])
    rng = ctx.rng("pool")
    tampers = []
    for k in range(tampered):
        ct = rng.randrange(5)
        row = n if k % 2 == 0 else rng.randrange(n)  # its b row, or an a row
        pos = (ct * (n + 1) + row) * ref.STORED + rng.randrange(88)
        tampers.append((k % honest, pos, rng.randrange(1, 256)))
    order = [honest + k for k in range(tampered)]
    order += [k % honest for k in range((every - 1) * tampered)]
    rng.shuffle(order)
    return tampers, order


def _pool(proofs: list, tampers: list) -> list:
    out = list(proofs)
    for base, pos, x in tampers:
        blob = bytearray(proofs[base])
        blob[pos] ^= x
        out.append(bytes(blob))
    return out


def prepare(ctx):
    from c_lwe_snarks_tpu_torch.models import snark, ssp
    from c_lwe_snarks_tpu_torch.ops import sampling
    from c_lwe_snarks_tpu_torch.utils import serial

    P = ctx.port_params()
    RP = ctx.ref_params()
    crs_key = sampling.PRGKey(ctx.seed_bytes("crs"), ctx.device)
    ent_key = sampling.PRGKey(ctx.seed_bytes("entropy"), ctx.device)
    wits, inst = ssp.random_ssp(ent_key, 0, P)
    crs, vrs = snark.setup(crs_key, ent_key, ssp.entropy_bytes_random_ssp(P), inst, P)
    proofs = [serial.proof_to_bytes(
        snark.prover(crs_key, ent_key, RP.prove_offset(k), crs, inst, wits, P), P)
        for k in range(int(ctx.traffic["honest"]))]
    del crs
    tampers, order = _plan(ctx, P.n)
    state = dict(P=P, vrs=vrs, ssp=inst, pool=_pool(proofs, tampers), order=order)
    ctx.phase("warm")
    for i in range(int(ctx.traffic["warm"])):
        request(ctx, state, i)
    return state


def request(ctx, state, i: int) -> tuple:
    from c_lwe_snarks_tpu_torch.models import snark
    from c_lwe_snarks_tpu_torch.utils import serial

    e = state["order"][i % len(state["order"])]
    blob = state["pool"][e]
    with ctx.spans("proof_from_bytes"):
        proof = serial.proof_from_bytes(blob, state["P"], ctx.device)
    with ctx.spans("verifier"):
        ok = snark.verifier(state["vrs"], state["ssp"], proof, state["P"])
    with ctx.spans("verdict"):
        return e, blob, bool(ok)


def _reference(ctx, q_bits=None) -> tuple:
    """(the pool, the request order, the verifier), all by the plain reference
    (at ``q_bits``, the control's lower precision, if given)."""
    RP = ctx.ref_params(q_bits)
    crs = Stream(ctx.seed_bytes("crs"), ctx.device)
    ent = Stream(ctx.seed_bytes("entropy"), ctx.device)
    key = ref.vrs(ent, RP)
    circ = ref.circuit(ent, RP, key.s, every_row=False)
    honest = ref.proofs(crs, ent, RP, circ, key,
                        [RP.prove_offset(k) for k in range(int(ctx.traffic["honest"]))])
    tampers, order = _plan(ctx, RP.n)
    return _pool(honest, tampers), order, lambda blob: ref.verify(blob, key, circ.t, circ.v0, RP)


def judge(ctx, answers: dict) -> list:
    """[(name, value, limit)]: the pool's bytes that differ from the
    reference's, and the verdicts of the window that differ from the
    reference verifier's on the reference's pool."""
    t0 = time.perf_counter()
    pool, _, verify = _reference(ctx)
    want = [verify(blob) for blob in pool]
    seen, pool_diff, verdict_diff = {}, 0, 0
    for got in answers.values():
        if got is None:
            verdict_diff += 1
            continue
        e, blob, ok = got
        seen[e] = blob
        verdict_diff += ok != want[e]
    for e, blob in seen.items():
        pool_diff += differing(blob, pool[e])
    print(f"verify check: {len(answers)} verdicts against the reference's on its pool of "
          f"{len(pool)} ({sum(want)} accepted) in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return [("pool_bytes_differing", pool_diff, 0), ("verdicts_differing", verdict_diff, 0)]


def control(ctx, picked, q_bits: int) -> dict:
    """The control's answers: the reference in the program's place at q_bits,
    making the pool and judging it."""
    pool, order, verify = _reference(ctx, q_bits)
    verdicts = [verify(blob) for blob in pool]
    out = {}
    for i in picked:
        e = order[i % len(order)]
        out[i] = (e, pool[e], verdicts[e])
    return out
