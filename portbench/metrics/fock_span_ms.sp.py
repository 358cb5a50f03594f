"""Device ms per request of the kernels the program launched inside its
``fock`` spans (the SCF's builds and the final one), from its own span
record."""
from pbench import spans


def read(data):
    return spans.device_ms(data, "fock")
