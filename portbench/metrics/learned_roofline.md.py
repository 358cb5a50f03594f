"""The learned-parameter network's forward against the card's FP32 peak
(67 TFLOP/s): the operations HIP-NN's published widths need (the
``pm3-hipnn-small-organics`` configuration's network; another learned
model's span would need its own count) for the
``molecules`` and ``atoms`` counts of the program's ``learned`` spans
(``pbench/hipnn_ops.py``), at the peak, over the device time of the
kernels launched inside those spans, in %; absent where the program
opens no such span."""
from pbench import hipnn_ops, roofline, spans


def read(data):
    att = spans.attribution(data)
    if att is None:
        return None
    recs = att.named("learned")
    ns = att.self_ns.get("learned", 0)
    if not recs or ns <= 0:
        return None
    flops = sum(hipnn_ops.forward_flops(r.counts.get("molecules", 0),
                                        r.counts.get("atoms", 0))
                for r in recs)
    return 100.0 * flops / roofline.PEAK_FP32 / (ns * 1e-9)
