"""polys_idle_ms.prove: device-idle milliseconds a proof in the gaps that
begin while ``lwe.prover.polys`` (the program's span inside
``snark.prover_polys``: w, v and h = (v^2 - 1) / t) is the innermost program
span open, the program's records put on the trace's clock
(``portbench/program.py``)."""

from portbench import program


def read(r):
    idle = program.idle_by_span(r)
    return None if idle is None else 1e3 * idle.get("lwe.prover.polys", 0.0) / r.requests
