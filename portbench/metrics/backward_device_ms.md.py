"""Device ms per XL step of the kernels launched by the autograd engine (the
force backward)."""
from pbench import readers


def read(data):
    return readers.backward_ms(data)
