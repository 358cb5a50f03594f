"""K2's least time over its kernel time in the profiled requests: FP32
operations at 67 TFLOP/s for the Jacobi sweeps the sampled molecules'
converged Fock matrices need, counted after the window."""
from pbench import readers


def read(data):
    return readers.k2_roofline(data)
