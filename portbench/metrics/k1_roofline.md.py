"""K1's least time over its kernel time in the profiled XL steps: FP32
operations at 67 TFLOP/s for the SP2 iterations the last step's inputs
need, counted by the plain purifier after the window."""
from pbench import readers


def read(data):
    return readers.k1_roofline(data)
