"""Device ms per XL step of the kernels the program launched inside its
``fock`` spans (every Fock build), from its own span record."""
from pbench import spans


def read(data):
    return spans.device_ms(data, "fock")
