"""k3_roofline_pct.<cell kind>: K3's share of its roofline, in %.  The least
time the card could take for the traffic's ``clients`` (C, 1 by default)
outstanding proofs is one sweep over every CRS term with the 5 C
coefficient rows of all of them (``roofline.eval_bound_ms``, from the
configuration's shapes), so a proof's bound is that sweep's over C, against
K3's device time per answered proof in the profiler's trace.  It reads the
same work whatever implements it: with one client it is one proof's sweep,
a sweep a proof reads 1 / C of a shared sweep's share, and no sweep reads
over 100 % unless it beats the bound."""

from portbench import roofline

K3 = r"\beval_mac_kernel\b"


def read(r):
    if r.trace is None or not r.requests or not r.trace.count(K3):
        return None
    clients = int(r.traffic.get("clients", 1))
    per_proof_ms = 1e3 * r.trace.device_s(K3) / r.requests
    return 100 * roofline.eval_bound_ms(r.cfg, lanes=5 * clients) / clients / per_proof_ms
