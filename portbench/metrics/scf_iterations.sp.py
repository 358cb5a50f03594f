"""K2 launches per request, from the port's counter eigh_kernel.launches:
one per SCF iteration, polish included."""


def read(data):
    return data.get("k2_per_request")
