"""serial_host_ms.<cell kind>: host milliseconds a request in the program's
``lwe.serial.*`` spans (the artifacts layer: a proof, CRS or VRS to bytes
or back).  One reader for every cell: the harness finds it for
``serial_host_ms.prove``, ``.setup`` and ``.verify`` alike."""

from portbench import program


def read(r):
    return program.host_ms(r, lambda name: name.startswith(program.SERIAL))
