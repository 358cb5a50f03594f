"""Device ms per XL step of the kernels the program launched inside its
``integrals`` span (the core Hamiltonian and two-electron integrals,
forward), from its own span record."""
from pbench import spans


def read(data):
    return spans.device_ms(data, "integrals")
