"""launches.<cell kind>: the port's hand-written kernel launches a request
(its ``LAUNCHES`` counters) inside the program's outermost spans.  One
reader for every cell: ``launches.prove``, ``.setup`` and ``.verify``."""

from portbench import program


def read(r):
    return program.per_request(r, "launches")
