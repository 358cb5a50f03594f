"""K2's own Jacobi sweeps per molecule and launch, averaged over the
profiled requests' eigensolves: the ``eigh_sweeps`` and ``molecules``
counts of the program's ``density`` spans."""
from pbench import spans


def read(data):
    att = spans.attribution(data)
    return None if att is None else att.per_molecule("eigh_sweeps")
