"""k4_roofline_pct.setup: K4's share of its roofline, in %: the least time
the card could take for one circuit's 2d + m encryptions
(``roofline.encrypt_bound_ms``, from the configuration's shapes), over K4's
device time per circuit in the profiler's trace."""

from portbench import roofline

K4 = r"\bencrypt_kernel\b"


def read(r):
    if r.trace is None or not r.requests or not r.trace.count(K4):
        return None
    per_circuit_ms = 1e3 * r.trace.device_s(K4) / r.requests
    return 100 * roofline.encrypt_bound_ms(r.cfg) / per_circuit_ms
