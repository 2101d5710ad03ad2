"""Shared turbulence-model infrastructure (port of `cfdnn_tpu/turbulence/base.py`).

Each closure is a small object with two methods the step calls:

    advance(state, sim, dt) -> state    # transport PDEs (k, omega), if any
    nu_t(state, sim)        -> tensor   # eddy viscosity at cell centers

The tensor algebra operates on the 9-component cell-centered velocity
gradient of `ops.operators.velocity_gradient` in plain PyTorch; the LES
closures' hand-written kernels (`ops/kernels.py` nu_sgs, germano_pass1)
are held to it. Not ported yet: `wall_distance`, `u_tau_wall` and
`k_omega_channel_estimate`, which come with the RANS closures (ROADMAP
A.11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import operators as ops
from ..utils.numerics import safe_sqrt

Tensor = torch.Tensor


class TurbulenceModelBase:
    """Protocol/base for all closures."""

    name = "base"
    uses_transport = False
    provides_reynolds_stresses = False
    # the hand-written kernel that computes nu_t, where one serves the
    # model: "nu_sgs" | "germano_pass1" (solver.KernelPlan.closure)
    kernel = None

    def initialize(self, state, sim):
        """Optional state initialization (k/omega estimates)."""
        return state

    def advance(self, state, sim, dt):
        return state

    def nu_t(self, state, sim) -> Optional[Tensor]:
        raise NotImplementedError

    def advance_and_nu_t(self, state, sim, dt):
        """(advanced state, nu_t): the per-step turbulence sequence."""
        state = self.advance(state, sim, dt)
        return state, self.nu_t(state, sim)

    def reynolds_stresses(self, state, sim):
        return None


# ---------------------------------------------------------------------------
# Strain / rotation tensor algebra
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StrainRotation:
    """Cell-centered S_ij / Omega_ij components and magnitudes."""

    S: Tuple[Tuple[Tensor, ...], ...]      # symmetric 3x3
    O12: Tensor                            # Omega_xy
    O13: Tensor
    O23: Tensor
    S_mag: Tensor                          # sqrt(2 S_ij S_ij)
    O_mag: Tensor                          # sqrt(2 O_ij O_ij)
    G: Tuple[Tuple[Tensor, ...], ...]      # raw gradient d u_i / d x_j


def strain_rotation(comps, geom) -> StrainRotation:
    G = ops.velocity_gradient(comps, geom)
    S11, S22, S33 = G[0][0], G[1][1], G[2][2]
    S12 = 0.5 * (G[0][1] + G[1][0])
    S13 = 0.5 * (G[0][2] + G[2][0])
    S23 = 0.5 * (G[1][2] + G[2][1])
    O12 = 0.5 * (G[0][1] - G[1][0])
    O13 = 0.5 * (G[0][2] - G[2][0])
    O23 = 0.5 * (G[1][2] - G[2][1])
    SS = (S11 * S11 + S22 * S22 + S33 * S33
          + 2.0 * (S12 * S12 + S13 * S13 + S23 * S23))
    OO = 2.0 * (O12 * O12 + O13 * O13 + O23 * O23)
    S = ((S11, S12, S13), (S12, S22, S23), (S13, S23, S33))
    return StrainRotation(
        S=S, O12=O12, O13=O13, O23=O23,
        S_mag=safe_sqrt(2.0 * SS), O_mag=safe_sqrt(2.0 * OO),
        G=tuple(tuple(row) for row in G),
    )


def cell_center_velocity(comps, geom):
    """(u, v, w) interpolated to cell centers."""

    def center(i):
        ax = geom.axes[i]
        if ax.n > 1:
            return ops.f2c_mean(comps[i], i, ax)
        c = comps[i]
        if c.shape[i] == 2:
            # unit axis with stored boundary faces (e.g. Nz=1, bc_z=WALL):
            # the single cell's center value is the face mean
            c = 0.5 * (c.select(i, 0) + c.select(i, 1)).unsqueeze(i)
        return c.expand(tuple(geom.axes[a].n for a in range(3)))

    return tuple(center(i) for i in range(3))


# ---------------------------------------------------------------------------
# LES filter width
# ---------------------------------------------------------------------------


def filter_width(geom) -> Tensor:
    """Local filter width Delta from the cell volume, (1, Ny, 1).

    3-D: (dx dy_j dz)^(1/3); 2-D: (dx dy_j)^(1/2). A stretched z takes its
    per-cell dz (ducts).
    """
    x, y, z = geom.axes
    dy = y.d
    if z.n > 1:
        dz = z.h if z.uniform else z.d
        return (x.h * dy * dz) ** (1.0 / 3.0)
    return torch.sqrt(x.h * dy)
