"""Share (%) of the overlap cells of the profiled requests that the
program's overlap kernel computed: ``overlap.kernel_cells`` over it plus
``overlap.plain_cells``, the counts of the program's ``integrals`` spans;
absent where the program keeps no such count."""
from pbench import spans


def read(data):
    att = spans.attribution(data)
    if att is None:
        return None
    kernel, plain = (sum(v for v, _ in att.counts("integrals", key))
                     for key in ("overlap.kernel_cells",
                                 "overlap.plain_cells"))
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None
