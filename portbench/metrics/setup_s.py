"""setup_s: seconds from the process's start to the end of set-up (imports,
the kernel library, the cell's state on the device, the warm requests)."""


def read(r):
    return r.setup_s
