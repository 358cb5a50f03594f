"""K1's own iteration count per molecule, averaged over the profiled XL
steps' SP2 solves: the ``sp2_iterations`` and ``molecules`` counts of the
program's ``density`` spans."""
from pbench import spans


def read(data):
    att = spans.attribution(data)
    return None if att is None else att.per_molecule("sp2_iterations")
