"""Device ms per XL step of the kernels the program launched inside its
``learned`` spans (the forward of the learned-parameter network), from
its own span record; absent where the program opens no such span."""
from pbench import spans


def read(data):
    return spans.device_ms(data, "learned")
