from .energy import SEQMConfig, energy, force, hamiltonian  # noqa: F401
