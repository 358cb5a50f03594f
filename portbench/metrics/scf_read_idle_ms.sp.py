"""Idle device ms per request from the end of each of the program's
``scf.read`` spans (a host read of the SCF's convergence flags) to the
first activity that starts on the card after it: what the reads cost the
card."""
from pbench import spans


def read(data):
    att = spans.attribution(data)
    if att is None or not att.named("scf.read"):
        return None
    return 1e-6 * sum(att.idle_after(r.end_ns)
                      for r in att.named("scf.read")) / att.units
