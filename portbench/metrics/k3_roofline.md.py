"""K3's least time over its kernel time in the profiled XL steps, forward and
backward by kernel name, bytes per cell as K3_IO counts them at 3.35 TB/s."""
from pbench import readers


def read(data):
    return readers.k3_roofline(data)
