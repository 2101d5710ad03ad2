"""Algebraic eddy-viscosity closures: mixing length (baseline) and GEP
(port of `cfdnn_tpu/turbulence/algebraic.py`). Each is one plain
expression over the cell-centred gradient tensor; no kernel of the port
serves them (nor did one of the reference's)."""

from __future__ import annotations

import torch

from ..utils.numerics import safe_tanh
from .base import (TurbulenceModelBase, strain_rotation, u_tau_wall,
                   wall_distance)


class MixingLengthModel(TurbulenceModelBase):
    """nu_t = l_mix^2 |S|, l_mix = min(kappa y (1 - e^{-y+/A+}), delta/2):
    y+ from the instantaneous wall-gradient u_tau, nu_t capped at
    1000 nu, and 0.5/0.5 under-relaxation against the previous step's
    nu_t."""

    name = "MixingLength"

    def __init__(self, cfg, mesh, geom, kappa=0.41, A_plus=26.0):
        self.kappa = kappa
        self.A_plus = A_plus
        self.delta = 0.5 * cfg.Ly
        self.nu = cfg.nu
        self.y_wall = wall_distance(mesh, cfg, geom.dtype,
                                    device=geom.axes[0].inv_d.device)

    def nu_t(self, state, sim):
        comps = state.velocity
        sr = strain_rotation(comps, sim.geom)
        u_tau = u_tau_wall(comps, sim.geom, self.nu)
        y_plus = self.y_wall * u_tau / self.nu
        damping = 1.0 - torch.exp(-y_plus / self.A_plus)
        l_mix = torch.clamp(self.kappa * self.y_wall * damping,
                            max=0.5 * self.delta)
        nut = torch.clamp(l_mix ** 2 * sr.S_mag, max=1000.0 * self.nu)
        if state.nu_t is not None:
            nut = 0.5 * nut + 0.5 * state.nu_t  # under-relax the feedback
        return nut


class GEPModel(TurbulenceModelBase):
    """Weatheritt-Sandberg GEP algebraic correction model: fixed
    symbolic-regression formulas, no trained weights. Variants: 0 =
    WS2016_Channel, 1 = WS2016_PeriodicHill, 2 = Simple."""

    name = "GEP (Weatheritt-Sandberg)"

    def __init__(self, cfg, mesh, geom, variant: int = 0,
                 kappa=0.41, A_plus=26.0):
        self.variant = variant
        self.kappa = kappa
        self.A_plus = A_plus
        self.nu = cfg.nu
        self.y_wall = wall_distance(mesh, cfg, geom.dtype,
                                    device=geom.axes[0].inv_d.device)

    def nu_t(self, state, sim):
        sr = strain_rotation(state.velocity, sim.geom)
        S, Om = sr.S_mag, sr.O_mag
        y = torch.clamp(self.y_wall, min=1e-10)
        # local y+ proxy y sqrt(S / nu): near a wall S ~ u_tau^2 / nu, so
        # sqrt(nu S) ~ u_tau and this is y u_tau / nu (the reference C++
        # code's S y / nu is inflated by ~Re_tau and saturates the damping)
        y_plus = y * torch.sqrt(S / (self.nu + 1e-20))
        f_damp = (1.0 - torch.exp(-y_plus / self.A_plus)) ** 2
        ratio = torch.where(S > 1e-10, Om / torch.clamp(S, min=1e-10),
                            torch.ones_like(S))
        if self.variant == 0:      # WS2016_Channel
            f_gep = f_damp / (1.0 + 0.1 * ratio ** 2)
        elif self.variant == 1:    # WS2016_PeriodicHill
            f_gep = safe_tanh(y_plus / 50.0) / (1.0 + 0.2 * ratio ** 2)
        else:                      # Simple
            f_gep = f_damp
        length = self.kappa * y * f_gep
        return torch.clamp(length * length * S, 0.0, 1000.0 * self.nu)
