"""prove_p95_ms: the 95th percentile (nearest rank) of every proof's latency
in the window, from the request's issue to its bytes on the host."""

import math


def read(r):
    lat = sorted(r.latencies_s)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
