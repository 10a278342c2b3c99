"""Entry ``setup``: one new circuit set up a request.

Request i makes a circuit from its own two seeds: ``ssp.random_ssp`` (in
this repository's seeded form it stands in for compiling the circuit), then
``snark.setup``, and ends when t, the CRS (``serial.crs_to_bytes``) and the
VRS (``serial.vrs_to_bytes``) are bytes on the host.  The check derives
again with the plain reference t, every CRS row and the VRS of a sample of
the window's circuits drawn from the seed.
"""

from __future__ import annotations

import sys
import time

from portbench.checks import differing
from portbench.reference import protocol as ref
from portbench.reference.aes import Stream


def _seeds(ctx, i: int) -> tuple:
    return ctx.seed_bytes("circuit", i, "crs"), ctx.seed_bytes("circuit", i, "entropy")


def prepare(ctx):
    state = dict(P=ctx.port_params())
    ctx.phase("warm")
    for i in range(int(ctx.traffic["warm"])):
        request(ctx, state, i)
    return state


def request(ctx, state, i: int) -> tuple:
    import torch

    from c_lwe_snarks_tpu_torch.models import snark, ssp
    from c_lwe_snarks_tpu_torch.ops import sampling
    from c_lwe_snarks_tpu_torch.utils import serial

    P = state["P"]
    crs_seed, ent_seed = _seeds(ctx, i)
    crs_key = sampling.PRGKey(crs_seed, ctx.device)
    ent_key = sampling.PRGKey(ent_seed, ctx.device)
    with ctx.spans("random_ssp", sync=True):
        wits, inst = ssp.random_ssp(ent_key, 0, P)
    with ctx.spans("setup"):
        crs, vrs = snark.setup(crs_key, ent_key, ssp.entropy_bytes_random_ssp(P), inst, P)
    t = inst.t.view(torch.int32).cpu().numpy().tobytes()
    with ctx.spans("crs_to_bytes"):
        crs_blob = serial.crs_to_bytes(crs, P)
    with ctx.spans("vrs_to_bytes"):
        vrs_blob = serial.vrs_to_bytes(vrs, P)
    return t, crs_blob, vrs_blob


def _t_bytes(t) -> bytes:
    return t.cpu().numpy().astype("<u4").tobytes()


def expected(ctx, picked, q_bits=None) -> dict:
    """{request: (t, CRS, VRS) bytes} of the picked circuits, by the plain
    reference (at ``q_bits``, the control's lower precision, if given)."""
    RP = ctx.ref_params(q_bits)
    out = {}
    for i in picked:
        crs_seed, ent_seed = _seeds(ctx, i)
        st = ref.setup(Stream(crs_seed, ctx.device), Stream(ent_seed, ctx.device), RP)
        out[i] = (_t_bytes(st.t), st.crs, st.vrs)
    return out


def judge(ctx, answers: dict) -> list:
    """[(name, value, limit)]: the bytes of t, the CRS and the VRS of the kept
    circuits (a sample of the window's, drawn from the seed) that differ
    from the reference's."""
    t0 = time.perf_counter()
    diff = 0
    for i, want in expected(ctx, list(answers)).items():
        got = answers[i] or (None,) * 3
        diff += sum(differing(g, w) for g, w in zip(got, want))
    print(f"setup check: {len(answers)} circuits derived again in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return [("setup_bytes_differing", diff, 0)]


def control(ctx, picked, q_bits: int) -> dict:
    """The control's answers: the reference's circuits at q_bits."""
    return expected(ctx, picked, q_bits)
