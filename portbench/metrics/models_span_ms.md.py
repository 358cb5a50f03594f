"""Device ms per XL step of the kernels the program launched in the self time
of its ``model.force`` span and in its ``system`` span (the force model's
own work: species, system, parameters, relayouts), from its own span
record."""
from pbench import spans


def read(data):
    return spans.device_ms(data, "model.force", "system")
