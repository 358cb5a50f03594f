"""Device ms per request of the kernels the program launched inside its
``density`` spans (the SCF's eigensolves: K2 and its preparation), from its
own span record."""
from pbench import spans


def read(data):
    return spans.device_ms(data, "density")
