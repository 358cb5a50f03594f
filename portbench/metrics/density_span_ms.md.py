"""Device ms per XL step of the kernels the program launched inside its
``density`` spans (SP2 purification: K1 and its preparation), from its own
span record."""
from pbench import spans


def read(data):
    return spans.device_ms(data, "density")
