"""The control (the plain reference computed at float32 with TF32 on, put
in the port's place) comes out not correct against each cell's limits.
On the card only: TF32 exists there alone.  The size is a test's; the
control's readings at each cell's own size are in PERF.md."""
import pytest
import torch

from _harness import SEED, tiny_spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload,batch", [("xl-small", 4096),
                                            ("xl-nonane", 256),
                                            ("sp-small", 4096)])
def test_control_fails_a_limit(workload, batch):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products need an NVIDIA GPU")
    from pbench import cells
    spec = tiny_spec(workload, batch)
    cell = cells.KINDS[spec["traffic"]["kind"]](spec, SEED, "cuda", False)
    cell.setup()
    cell.window(1.0)
    values = cell.check(control=True)
    limits = spec["limits"]
    assert any(values[n] > limits[n] for n in limits), values
