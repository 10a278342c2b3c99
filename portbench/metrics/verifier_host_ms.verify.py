"""verifier_host_ms.verify: host milliseconds a verdict in the program's
``lwe.verifier`` span (``snark.verifier``: the wrapper's checks, its
allocations and K11's launch; the verdict's read is the benchmark's)."""

from portbench import program


def read(r):
    return program.host_ms(r, lambda name: name == "lwe.verifier")
