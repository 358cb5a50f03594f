"""Host reads of the SCF's convergence flags per request, each of which
waits for the card: the ``reads`` counts of the program's ``scf`` spans."""
from pbench import spans


def read(data):
    att = spans.attribution(data)
    got = [] if att is None else att.counts("scf", "reads")
    return sum(v for v, _ in got) / att.units if got else None
