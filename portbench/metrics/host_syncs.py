"""host_syncs.<cell kind>: the times a request the port's host waits on the
device (``spans.sync``: a read or copy to the host, a blocking copy to the
card) inside the program's outermost spans.  One reader for every cell:
``host_syncs.prove``, ``.setup`` and ``.verify``."""

from portbench import program


def read(r):
    return program.per_request(r, "syncs")
