"""Idle device ms per XL step in the gaps between busy stretches that end
on an activity the program launched inside its ``integrals`` span."""
from pbench import spans


def read(data):
    att = spans.attribution(data)
    if att is None or not att.named("integrals"):
        return None
    return 1e-6 * att.idle_ns().get("integrals", 0) / att.units
