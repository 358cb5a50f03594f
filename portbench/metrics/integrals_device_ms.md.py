"""Device ms per XL step of the forward kernels launched from the integrals
modules (ops/hcore, overlap, overlap_general, tetci, multipole at the
outermost frame of the port's ops), from one step profiled with Python
stacks."""
from pbench import readers


def read(data):
    return readers.integrals_ms(data)
