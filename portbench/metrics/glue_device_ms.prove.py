"""glue_device_ms.prove: device milliseconds a proof spends in every device
item but K3 (the keystream -> MAC sweep, ``eval_mac_kernel``): K6, K7, K10,
torch's own kernels, copies and sets, from the profiler's trace.  Without K3
in the trace it reads nothing: "all but K3" would then hold K3's work."""

K3 = r"\beval_mac_kernel\b"


def read(r):
    if r.trace is None or not r.requests or not r.trace.count(K3):
        return None
    return 1e3 * r.trace.device_s(K3, exclude=True) / r.requests
