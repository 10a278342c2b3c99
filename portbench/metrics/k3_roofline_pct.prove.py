"""k3_roofline_pct.prove: K3's share of its roofline, in %: the least time
the card could take for one proof's sweep over every CRS term
(``roofline.eval_bound_ms``, from the configuration's shapes), over K3's
device time per proof in the profiler's trace."""

from portbench import roofline

K3 = r"\beval_mac_kernel\b"


def read(r):
    if r.trace is None or not r.requests or not r.trace.count(K3):
        return None
    per_proof_ms = 1e3 * r.trace.device_s(K3) / r.requests
    return 100 * roofline.eval_bound_ms(r.cfg) / per_proof_ms
