"""device_idle_pct.<cell kind>: the share of the traced window, in %, in which
no device item ran: 1 - (the union of the device's intervals) / (the window).
One reader for every cell: the harness finds it for ``device_idle_pct.prove``,
``.setup`` and ``.verify`` alike."""


def read(r):
    if r.trace is None or not r.trace.device:
        return None
    return 100 * (1 - r.trace.busy_s / r.trace.window_s)
