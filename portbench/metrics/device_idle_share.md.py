"""Share of the profiled XL steps' host window in which no activity ran on the
card."""
from pbench import readers


def read(data):
    return readers.idle_share(data)
