"""polys_host_ms.prove: host milliseconds a proof spends in
``snark.prover_polys`` (w, v and h = (v^2 - 1) / t), from the span the
benchmark wraps around that call in the traced run."""


def read(r):
    spent = r.spans.total_s("prover_polys")
    return 1e3 * spent / r.requests if spent and r.requests else None
