"""k7_roofline_pct.<cell kind>: K7's share of its roofline, in %.  The least
time the card could take for the row-sums of the traffic's ``clients`` (C,
1 by default) outstanding proofs is one read of the union of their gated
rows of v (``roofline.rowsum_bound_ms``, from the configuration's shapes),
so a proof's bound is that read's over C, against the device time of K7,
in its one-witness form (``gated_rowsum_kernel``) or its many-witness form
(``gated_rowsums_kernel``), per answered proof in the profiler's trace."""

from portbench import roofline

K7 = r"\bgated_rowsums?_kernel\b"


def read(r):
    if r.trace is None or not r.requests or not r.trace.count(K7):
        return None
    clients = int(r.traffic.get("clients", 1))
    per_proof_ms = 1e3 * r.trace.device_s(K7) / r.requests
    return 100 * roofline.rowsum_bound_ms(r.cfg, clients) / clients / per_proof_ms
