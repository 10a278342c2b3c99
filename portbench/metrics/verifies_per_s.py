"""verifies_per_s: verdicts completed over the whole window, by the host clock."""


def read(r):
    return r.requests / r.window_s
