"""proofs_per_s: proofs completed over the whole window, by the host clock."""


def read(r):
    return r.requests / r.window_s
