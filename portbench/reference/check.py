"""The plain reference of each cell, worked out again from the inputs, and
the comparisons that decide ``correct``.

``Reference`` builds the frozen copy (``seqm/``) at a precision: float64
for the reference, or float32 with TF32 on for the control (the nearest
precision below the configurations' float32 with TF32 off).  Its XL step
is the port's ``XLBOMD.step`` written out plainly (velocity Verlet around
one XL force, the dissipative propagation of the density field with the
k = 3..9 coefficients of Niklasson et al., JCP 130, 214109 (2009)).
Everything runs in blocks of molecules, so the reference fits beside the
program's state.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from .seqm.models.energy import SEQMConfig, build, force
from .seqm.models.xlbomd import energy_xl
from .seqm.ops.density import (orbital_mask, packed_solver_size,
                               static_pack_mat, static_pack_vec)
from .seqm.parameters import load_element_tables
from .seqm.scf import SCFConfig

# (eV/Angstrom)/(g/mol) in Angstrom/fs^2
ACC_SCALE = 0.009648532800137615
# kappa, alpha, c0..ck per history order k
XL_COEFFS = {
    3: (1.69, 150e-3, (-2.0, 3.0, 0.0, -1.0)),
    4: (1.75, 57e-3, (-3.0, 6.0, -2.0, -2.0, 1.0)),
    5: (1.82, 18e-3, (-6.0, 14.0, -8.0, -3.0, 4.0, -1.0)),
    6: (1.84, 5.5e-3, (-14.0, 36.0, -27.0, -2.0, 12.0, -6.0, 1.0)),
    7: (1.86, 1.6e-3, (-36.0, 99.0, -88.0, 11.0, 32.0, -25.0, 8.0, -1.0)),
    8: (1.88, 0.44e-3, (-99.0, 286.0, -286.0, 78.0, 78.0, -90.0, 42.0,
                        -10.0, 1.0)),
    9: (1.89, 0.12e-3, (-286.0, 858.0, -936.0, 364.0, 168.0, -300.0, 184.0,
                        -63.0, 12.0, -1.0)),
}


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products in float32 matmuls while active (the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def method_elements(method: str) -> Tuple[int, ...]:
    """The atomic numbers that the method's parameter tables cover (those
    with a one-centre s energy)."""
    U_ss = load_element_tables(method, device="cpu",
                               dtype=torch.float64)["U_ss"]
    return tuple(int(z) for z in torch.nonzero(U_ss).flatten())


class Reference:
    """The frozen copy at one precision for one batch's static packed
    layout (heavy count K).  ``learned``: the plain side of a parameter
    model, f(species, coordinates) -> {name: (nmol, A)}, at this precision,
    or None (the method's tables); ``row3``: molecules with an element of
    row 3."""

    def __init__(self, method: str, dtype, device, K: int, scf: dict,
                 control: bool = False, learned=None, row3: bool = False):
        self.dtype = dtype
        self.control = control
        self.K = K
        self.learned = learned
        kw = dict(scf)
        kw["converger"] = tuple(kw["converger"])
        self.const, self.tables, self.cfg = build(
            method, dtype=dtype, device=device,
            scf=SCFConfig(pack_heavy=K, **kw), row3=row3)

    def _ctx(self):
        return tf32(self.control)

    def masses(self, species):
        m = self.const.mass[species]
        return torch.where(species > 0, m, torch.ones_like(m))[..., None]

    def xl_force(self, species, x, P):
        """(force eV/A, Hf eV, D, SP2 iterations per molecule) of the XL
        functional at coordinates x and density field P (packed)."""
        with self._ctx():
            coords = x.to(self.dtype).detach().requires_grad_(True)
            iters = []
            with torch.enable_grad():
                out = energy_xl(self.const, self.tables, self.cfg, species,
                                coords, P.to(self.dtype),
                                learned=self.learned, packed_io=True,
                                iters_out=iters)
                (g,) = torch.autograd.grad(out.Hf.sum(), coords)
        return -g.detach(), out.Hf.detach(), out.D.detach(), iters[0]

    def xl_step(self, species, st: Dict[str, torch.Tensor], step: int,
                k: int, dt: float):
        """One XL-BOMD step (NVE) from state ``st`` (x, v, acc, D, P, Pt:
        the ring buffer, (k+1, nmol, n, n)) at step counter ``step``."""
        kappa, alpha, cs = XL_COEFFS[k]
        m = k + 1
        coeff = [c * alpha for c in cs]
        coeff[0] += 2.0 - kappa
        coeff[1] -= 1.0
        ring = torch.as_tensor(coeff * 2, dtype=self.dtype,
                               device=st["x"].device)
        cindx = step % m
        c = ring[cindx:cindx + m]
        d = {n: t.to(self.dtype) for n, t in st.items()}
        mass = self.masses(species)
        v = d["v"] + 0.5 * d["acc"] * dt
        x = d["x"] + v * dt
        with self._ctx():
            P = kappa * d["D"] + torch.einsum('k,knij->nij', c, d["Pt"])
        f, Hf, D, _ = self.xl_force(species, x, P)
        acc = f / mass * ACC_SCALE
        v = v + 0.5 * acc * dt
        return {"x": x, "v": v, "P": P, "D": D, "f": f, "Hf": Hf}

    def single_point(self, species, coords) -> Dict[str, torch.Tensor]:
        """The SCF at coords: force (eV/A), Hf (eV), the converged density
        P (nmol, 4A, 4A) and packed (Pp), the packed converged Fock (Fp)
        and the notconverged flags."""
        with self._ctx():
            f, out = force(self.const, self.tables, self.cfg, species,
                           coords.to(self.dtype), learned=self.learned)
        n_st = packed_solver_size(self.K, species.shape[1])
        return {"f": f, "Hf": out.Hf, "P": out.P,
                "Pp": static_pack_mat(out.P, self.K, n_st),
                "Fp": static_pack_mat(out.F, self.K, n_st),
                "nc": out.notconverged}

    def packed_mask(self, species):
        from .seqm.system import make_system
        sys = make_system(self.const, species,
                          torch.zeros(species.shape + (3,), dtype=self.dtype,
                                      device=species.device),
                          heavy_count=self.K)
        n_st = packed_solver_size(self.K, species.shape[1])
        return static_pack_vec(orbital_mask(sys).to(self.dtype), self.K,
                               n_st)


def max_abs(a, b, mask: Optional[torch.Tensor] = None) -> float:
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = torch.where(mask, d, torch.zeros_like(d))
    return float(d.max()) if d.numel() else 0.0


class Worst:
    """Running maxima of the compared numbers."""

    def __init__(self):
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float):
        if value != value:            # NaN fails every limit
            value = float("inf")
        self.values[name] = max(self.values.get(name, 0.0), value)
