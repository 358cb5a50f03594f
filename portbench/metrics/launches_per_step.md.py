"""Kernel launches per XL step: the host's launch calls in the profiled steps
over their number."""
from pbench import readers


def read(data):
    return readers.launches_per_unit(data)
