"""ssp_ms.setup: milliseconds a circuit spends in ``ssp.random_ssp``, from
the benchmark's span around its call with a synchronize on both sides."""


def read(r):
    spent = r.spans.total_s("random_ssp")
    return 1e3 * spent / r.requests if spent and r.requests else None
