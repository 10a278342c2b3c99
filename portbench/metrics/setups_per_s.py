"""setups_per_s: circuits set up completed over the whole window, by the host clock."""


def read(r):
    return r.requests / r.window_s
