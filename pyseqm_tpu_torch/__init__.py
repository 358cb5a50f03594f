"""pyseqm_tpu_torch: the PyTorch/CUDA port of pyseqm_tpu.

Batched NDDO semiempirical quantum chemistry (AM1/MNDO/PM3) on an NVIDIA
GPU: energies, forces and parameter gradients by autograd (the SCF
differentiated by its recursive adjoint or unrolled, Hessians included)
and XL-BOMD molecular dynamics on the flat pair list, the ordered dense
grid, the class-segmented flat pair list, or the class-segmented dense
grid with the static packed electronic state; densities from the one-sided
Jacobi eigensolver (csrc/eigh.cu) or SP2 purification (csrc/sp2.cu), and
every Fock build's two-electron contraction from the fused apply
(csrc/wapply.cu), all hand-written CUDA kernels; learned per-atom
parameters from a network (models/ml.py) or the reference's trained
HIP-NN model (models/hipnn.py), with the Kbeta and g_ss_nuc hooks;
geometry optimization (drivers/opt.py: steepest descent, the warm batched
L-BFGS and the optax-routed L-BFGS); data parallelism over the molecule
axis on torch.distributed (parallel/); and checkpoints, trajectory dumps,
sanitizers and phase timing (utils/).
Entry points run on CUDA unless the caller passes device="cpu".  The
package imports torch and numpy only.
"""
from .compat import from_seqm_parameters  # noqa: F401
from .constants import (A0, EV, Constants, constants_from_numpy,  # noqa: F401
                        disable_tf32, make_constants)
from .models.energy import (EnergyOutput, HamiltonianOutput,  # noqa: F401
                            SEQMConfig, build, energy, force, hamiltonian)
from .ops.density import (packed_heavy_count,  # noqa: F401
                          packed_orbital_size, packed_solver_size)
from .parameters import (PARAMETER_LIST, load_element_tables,  # noqa: F401
                         tables_from_numpy)
from .scf import SCFConfig, SCFConvergenceError  # noqa: F401
from .system import System, make_system, sort_species  # noqa: F401

disable_tf32()

__version__ = "0.1.0"
