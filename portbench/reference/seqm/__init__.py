"""A frozen copy of the PyTorch port's NDDO modules, the benchmark's plain
reference.

The modules are the port's (constants, parameters, system, the integrals,
the Fock build, the density solvers, the energy, the SCF and the energy and
XL-BOMD models) with every hand-written kernel replaced by plain torch:
the two-electron apply is its plain contraction (``ops/wapply_kernel.py``),
every eigensolve is ``torch.linalg.eigh`` (``ops/eigh_kernel.py``) and SP2
runs the purifier kernel's algorithm step by step at any precision
(``ops/sp2_kernel.py``).  Nothing here imports the port, so a later change
to the port leaves the yardstick where it was.  It runs at float64 for the
reference and at float32 with TF32 on for the control.
"""
