"""Entry ``prove_batch``: proofs of W statements of one circuit, one
request outstanding for each of the traffic's ``clients`` (W of them).

Set-up makes the circuit on the device from the run's two seeds as ``prove``
does (``ssp.random_ssp``): its witness is statement 0, and its t stays.
Statements 1 .. W - 1 (W: the traffic's ``clients``) are witness bits
drawn as random_ssp draws its own, floor(m / 8) bytes of the AES-CTR stream
of ``ctx.seed_bytes("witness", b)``, so the top m % 8 bits are zero.  W - 1
pivot rows j_1 .. j_{W-1} are drawn from the seed among the rows >= 1 whose
gating bit is 0 in statement 0 and comes from the draw (``pivots``); in the
pivots' gating bits statement b has a 1 at j_b alone, and row j_b of v is
overwritten with (1 + b) t + 1 - v_0 - (the other rows statement b gates)
mod p.  So v_0 plus the rows statement b gates is (1 + b) t + 1, (v^2 - 1) / t
is exact for every statement as it is for statement 0 (t + 1), and each
statement has a row-sum of its own, in its gates and in its value, and a
b_w lane of its own.  Then ``snark.setup`` on that instance.

Request i proves statement i mod W from its own entropy (delta and five
smudging draws at ``prove_offset(i)``, as in ``prove``), and ends when the
proof's bytes (``serial.proof_to_bytes``) are on the host.  The harness
hands every outstanding request to ``serve`` at once.  Where the port has

    snark.prover_batch(crs_key, ent_key, offsets, crs, ssp, witnesses, params) -> list[Proof]

(offsets: each request's entropy offset; witnesses: each request's
statement's witness bits, uint8 [m] on the device; the proofs in the order
of offsets, each equal to ``snark.prover``'s for that offset and witness),
``serve`` calls it once for the requests handed to it; otherwise it calls
``snark.prover`` for each request in turn and yields each proof as it is
done.  The proofs of a ``prover_batch`` call go to the host, where the port has

    serial.proofs_to_bytes(proofs, params) -> list[bytes]

(one entry a proof, in order, each byte for byte
``serial.proof_to_bytes(proof, params)``), through one call of it for the
batch, inside one ``proof_to_bytes`` span; a call that raises fails every
request of the batch.  Otherwise each proof goes through
``serial.proof_to_bytes`` in a span of its own.  The check derives the W
statements and the sampled proofs again with the plain reference and
compares every byte.
"""

from __future__ import annotations

import sys
import time

from portbench.checks import differing
from portbench.reference import protocol as ref
from portbench.reference.aes import Stream


def pivots(ctx, bits0: list, count: int, m: int) -> list:
    """``count`` pivot rows drawn from the seed: rows j >= 1 whose gating bit
    j - 1 is 0 in statement 0 (bits0) and lies in the witness draw."""
    rows = [j for j in range(1, min(m - 1, 8 * (m // 8)) + 1) if not bits0[j - 1]]
    if len(rows) < count:
        raise ValueError(f"{count} pivot rows wanted, {len(rows)} rows free in statement 0")
    return ctx.rng("pivots").sample(rows, count)


def prepare(ctx):
    import torch

    from c_lwe_snarks_tpu_torch.models import snark, ssp
    from c_lwe_snarks_tpu_torch.ops import modp, sampling

    P = ctx.port_params()
    W = int(ctx.traffic["clients"])
    crs_key = sampling.PRGKey(ctx.seed_bytes("crs"), ctx.device)
    ent_key = sampling.PRGKey(ctx.seed_bytes("entropy"), ctx.device)
    wits0, inst = ssp.random_ssp(ent_key, 0, P)
    piv = pivots(ctx, wits0.tolist(), W - 1, P.m)
    gates = [j - 1 for j in piv]
    wits, rows = [wits0], []
    for b in range(1, W):
        key = sampling.PRGKey(ctx.seed_bytes("witness", b), ctx.device)
        bits = ssp.witness_bits(sampling.keystream_bytes(key, 0, P.m // 8), P.m)
        bits[gates] = 0
        rest = modp.gated_rowsum_mod_p(inst.v[1:], bits[: P.m - 1])
        bits[gates[b - 1]] = 1
        lead = modp.mulmod_p(inst.t, 1 + b)
        lead[0] = modp.addmod_p(lead[0], 1)
        rows.append(modp.submod_p(modp.submod_p(lead, inst.v[0]), rest))
        wits.append(bits)
    for j, row in zip(piv, rows):  # after every row-sum: each reads the rows as drawn
        inst.v[j] = row.to(torch.uint32)
    crs, _ = snark.setup(crs_key, ent_key, ssp.entropy_bytes_random_ssp(P), inst, P)
    state = dict(P=P, RP=ctx.ref_params(), W=W, crs_key=crs_key, ent_key=ent_key, wits=wits,
                 ssp=inst, crs=crs)
    ctx.phase("warm")
    for _ in serve(ctx, state, range(int(ctx.traffic["warm"]))):
        pass
    return state


def serve(ctx, state, indices):
    """(i, the proof's bytes, None if it failed) for every request handed,
    each as it is done."""
    from c_lwe_snarks_tpu_torch.models import snark
    from c_lwe_snarks_tpu_torch.utils import serial

    P, indices = state["P"], list(indices)
    offsets = [state["RP"].prove_offset(i) for i in indices]
    wits = [state["wits"][i % state["W"]] for i in indices]
    batch = getattr(snark, "prover_batch", None)
    if batch is not None:
        with ctx.spans("prover"):
            proofs = batch(state["crs_key"], state["ent_key"], offsets, state["crs"],
                           state["ssp"], wits, P)
        yield from written(ctx, indices, proofs, P)
        return
    for i, off, w in zip(indices, offsets, wits):
        try:
            with ctx.spans("prover"):
                pi = snark.prover(state["crs_key"], state["ent_key"], off, state["crs"],
                                  state["ssp"], w, P)
            with ctx.spans("proof_to_bytes"):
                answer = serial.proof_to_bytes(pi, P)
        except Exception as exc:  # noqa: BLE001 - a failed request is counted, the others go on
            print(f"request {i} failed: {exc!r}", file=sys.stderr)
            answer = None
        yield i, answer


def written(ctx, indices: list, proofs: list, P):
    """(i, proof i's bytes) for the requests of one ``prover_batch`` call:
    one call of ``serial.proofs_to_bytes`` where the port has it (None for
    every request if it raises), else ``serial.proof_to_bytes`` a proof."""
    from c_lwe_snarks_tpu_torch.utils import serial

    write_all = getattr(serial, "proofs_to_bytes", None)
    if write_all is None:
        for i, pi in zip(indices, proofs):
            with ctx.spans("proof_to_bytes"):
                answer = serial.proof_to_bytes(pi, P)
            yield i, answer
        return
    try:
        with ctx.spans("proof_to_bytes"):
            answers = write_all(proofs, P)
    except Exception as exc:  # noqa: BLE001 - the batch's requests are counted as failed
        print(f"requests {indices} failed: {exc!r}", file=sys.stderr)
        answers = [None] * len(indices)
    yield from zip(indices, answers)


def expected(ctx, picked, q_bits=None) -> dict:
    """{request: proof bytes} by the plain reference (at ``q_bits``, the
    control's lower precision, if given)."""
    RP = ctx.ref_params(q_bits)
    W = int(ctx.traffic["clients"])
    crs = Stream(ctx.seed_bytes("crs"), ctx.device)
    ent = Stream(ctx.seed_bytes("entropy"), ctx.device)
    key = ref.vrs(ent, RP)
    piv = pivots(ctx, ref.witness_bits(ent, RP).tolist(), W - 1, RP.m)
    others = [ref.witness_bits(Stream(ctx.seed_bytes("witness", b), ctx.device), RP)
              for b in range(1, W)]
    circs = ref.statement_circuits(ent, RP, key.s, others, piv)
    proofs = ref.proofs(crs, ent, RP, [circs[i % W] for i in picked], key,
                        [RP.prove_offset(i) for i in picked])
    return dict(zip(picked, proofs))


def judge(ctx, answers: dict) -> list:
    """[(name, value, limit)]: the bytes by which the kept proofs (a sample
    of the window's, drawn from the seed) differ from the reference's proofs
    of the same statements and offsets."""
    t0 = time.perf_counter()
    want = expected(ctx, list(answers))
    diff = sum(differing(answers[i], w) for i, w in want.items())
    print(f"prove_batch check: {len(want)} proofs derived again in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return [("proof_bytes_differing", diff, 0)]


def control(ctx, picked, q_bits: int) -> dict:
    """The control's answers: the reference's proofs at q_bits."""
    return expected(ctx, picked, q_bits)
