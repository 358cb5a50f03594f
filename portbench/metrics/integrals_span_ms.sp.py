"""Device ms per request of the kernels the program launched inside its
``integrals`` span, from its own span record."""
from pbench import spans


def read(data):
    return spans.device_ms(data, "integrals")
