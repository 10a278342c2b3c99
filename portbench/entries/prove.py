"""Entry ``prove``: one proof of the cell's circuit a request.

Set-up makes the circuit (random_ssp) and its CRS (setup) on the device from
the run's two seeds.  Request i runs ``snark.prover`` from its own entropy,
delta and the five smudging draws at stream offset off_prove + i * (8 + 5 *
81), and ends when the proof's bytes (``serial.proof_to_bytes``) are on the
host.  The check derives the circuit and the sampled proofs again with the
plain reference and compares every byte.
"""

from __future__ import annotations

import sys
import time

from portbench.checks import differing
from portbench.reference import protocol as ref
from portbench.reference.aes import Stream


def prepare(ctx):
    from c_lwe_snarks_tpu_torch.models import snark, ssp
    from c_lwe_snarks_tpu_torch.ops import sampling

    P = ctx.port_params()
    crs_key = sampling.PRGKey(ctx.seed_bytes("crs"), ctx.device)
    ent_key = sampling.PRGKey(ctx.seed_bytes("entropy"), ctx.device)
    wits, inst = ssp.random_ssp(ent_key, 0, P)
    off_setup = ssp.entropy_bytes_random_ssp(P)
    crs, _ = snark.setup(crs_key, ent_key, off_setup, inst, P)
    state = dict(P=P, RP=ctx.ref_params(), crs_key=crs_key, ent_key=ent_key, wits=wits,
                 ssp=inst, crs=crs)
    ctx.phase("warm")
    for i in range(int(ctx.traffic["warm"])):
        request(ctx, state, i)
    return state


def request(ctx, state, i: int) -> bytes:
    from c_lwe_snarks_tpu_torch.models import snark
    from c_lwe_snarks_tpu_torch.utils import serial

    P = state["P"]
    with ctx.spans("prover"):
        pi = snark.prover(state["crs_key"], state["ent_key"], state["RP"].prove_offset(i),
                          state["crs"], state["ssp"], state["wits"], P)
    with ctx.spans("proof_to_bytes"):
        return serial.proof_to_bytes(pi, P)


def instrument(ctx):
    """Time ``snark.prover_polys`` on the host in the traced run; returns the
    undo.  Raises if the program no longer has it."""
    from c_lwe_snarks_tpu_torch.models import snark

    original = snark.prover_polys  # AttributeError: the metric's span has nothing to wrap

    def timed(*args, **kwargs):
        with ctx.spans("prover_polys"):
            return original(*args, **kwargs)

    snark.prover_polys = timed
    return lambda: setattr(snark, "prover_polys", original)


def expected(ctx, picked, q_bits=None) -> dict:
    """{request: proof bytes} by the plain reference (at ``q_bits``, the
    control's lower precision, if given)."""
    RP = ctx.ref_params(q_bits)
    crs = Stream(ctx.seed_bytes("crs"), ctx.device)
    ent = Stream(ctx.seed_bytes("entropy"), ctx.device)
    key = ref.vrs(ent, RP)
    circ = ref.circuit(ent, RP, key.s, every_row=False)
    proofs = ref.proofs(crs, ent, RP, circ, key, [RP.prove_offset(i) for i in picked])
    return dict(zip(picked, proofs))


def judge(ctx, answers: dict) -> list:
    """[(name, value, limit)]: the bytes by which the kept proofs (a sample
    of the window's, drawn from the seed) differ from the reference's."""
    t0 = time.perf_counter()
    want = expected(ctx, list(answers))
    diff = sum(differing(answers[i], w) for i, w in want.items())
    print(f"prove check: {len(want)} proofs derived again in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return [("proof_bytes_differing", diff, 0)]


def control(ctx, picked, q_bits: int) -> dict:
    """The control's answers: the reference's proofs at q_bits."""
    return expected(ctx, picked, q_bits)
