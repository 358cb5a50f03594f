"""Device ms per XL step of the kernels the program launched inside its
``energy`` spans (electronic, core-core and isolated-atom terms and their
assembly), from its own span record."""
from pbench import spans


def read(data):
    return spans.device_ms(data, "energy")
