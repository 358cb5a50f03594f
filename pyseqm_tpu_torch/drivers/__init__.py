from .md import (MDConfig, MDState, MolecularDynamics,  # noqa: F401
                 LangevinDynamics, initialize_velocity, kinetic_energy,
                 zero_com)
from .xlbomd import XLBOMD, XLBOMDState  # noqa: F401
from .opt import geometry_optimize_sd, geometry_optimize_sd_ls  # noqa: F401
