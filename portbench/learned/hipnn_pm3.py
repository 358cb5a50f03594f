"""The trained HIP-NN parameter model, the port's side: the callable a user
hands to ``XLBOMD(..., learned=)`` and ``force(..., learned=)``, built by
the port's public ``make_hipnn_callable`` from the weights it ships
(``pyseqm_tpu_torch/params/hipnn_pm3.npz``)."""


def program(device, dtype):
    from pyseqm_tpu_torch.models.hipnn import make_hipnn_callable
    return make_hipnn_callable(dtype=dtype, device=device)
