"""Device ms per XL step of the kernels the program launched in the self time
of its ``md.step`` span (the driver's propagation, history sum and
observables), from its own span record."""
from pbench import spans


def read(data):
    return spans.device_ms(data, "md.step")
