"""Shared turbulence-model infrastructure (port of `cfdnn_tpu/turbulence/base.py`).

Each closure is a small object with two methods the step calls:

    advance(state, sim, dt) -> state    # transport PDEs (k, omega), if any
    nu_t(state, sim)        -> tensor   # eddy viscosity at cell centers

The tensor algebra operates on the 9-component cell-centered velocity
gradient of `ops.operators.velocity_gradient` in plain PyTorch; the LES
closures' hand-written kernels (`ops/kernels.py` nu_sgs, germano_pass1)
are held to it. The wall helpers (`wall_distance`, `u_tau_wall`,
`k_omega_channel_estimate`) serve the RANS closures.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import BCType, Config
from ..mesh import Mesh
from ..ops import operators as ops
from ..utils.numerics import safe_sqrt

Tensor = torch.Tensor


class TurbulenceModelBase:
    """Protocol/base for all closures."""

    name = "base"
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
# Wall geometry helpers
# ---------------------------------------------------------------------------


def wall_distance_host(mesh: Mesh, cfg: Config, dtype) -> np.ndarray:
    """Distance to the nearest wall on the host, in the working dtype
    (`dtype`, a torch dtype) so that a scalar derived from it on the host
    (the omega wall value, the y+ pin mask) is the one the device values
    give. Broadcastable: (1, Ny, 1) with y walls, (1, 1, Nz) with z walls
    only, (1, Ny, Nz) with both (the min over the walls: ducts); with no
    wall, the channel half-height everywhere (1, 1, 1)."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    dists = []
    if cfg.bc_y == BCType.WALL:
        dists.append(mesh.wall_distance_y().reshape(1, -1, 1))
    if cfg.bc_z == BCType.WALL and mesh.Nz > 1:
        zc = mesh.z.centers
        dz = np.minimum(zc - mesh.z.lo, mesh.z.hi - zc)
        dists.append(dz.reshape(1, 1, -1))
    if not dists:
        return np.full((1, 1, 1), 0.5 * cfg.Ly, np_dtype)
    d = dists[0]
    for extra in dists[1:]:
        d = np.minimum(d, extra)
    return np.maximum(d, 1e-10).astype(np_dtype)


def wall_distance(mesh: Mesh, cfg: Config, dtype, *, device) -> Tensor:
    """`wall_distance_host` as a tensor on `device`."""
    return torch.as_tensor(wall_distance_host(mesh, cfg, dtype),
                           device=device)


def u_tau_wall(comps, geom, nu: float) -> Tensor:
    """Friction velocity estimate from the mean wall velocity gradient
    (u_tau = sqrt(nu <|du/dy|>_wall)), from the first interior u value
    and the wall distance of the first cell. The shear is taken relative
    to the wall's own tangential velocity (AxisGeom.tang: a moving lid),
    so a lid wall reports no phantom O(U_lid / d) shear."""
    u = comps[0]
    y = geom.axes[1]
    d_lo = y.centers.reshape(-1)[0] - y.faces.reshape(-1)[0]
    d_hi = y.faces.reshape(-1)[-1] - y.centers.reshape(-1)[-1]
    wall_lo, wall_hi = y.tang[0]
    dudy_lo = torch.mean(torch.abs(u[:, 0, :] - wall_lo)) / d_lo
    dudy_hi = torch.mean(torch.abs(wall_hi - u[:, -1, :])) / d_hi
    dudy = 0.5 * (dudy_lo + dudy_hi)
    return torch.clamp(torch.sqrt(nu * dudy), min=1e-6)


def k_omega_channel_estimate(comps, geom, y_wall: Tensor, nu: float,
                             C_mu: float = 0.09):
    """Algebraic (k, omega) initial estimate for wall-bounded flows: k =
    u_tau^2 / sqrt(C_mu) f_mu^2 with a van-Driest-like f_mu, omega from
    the log-layer relation sqrt(k) / (C_mu^0.25 kappa y). Cell fields
    (Nx, Ny, Nz), contiguous, in the velocity's dtype."""
    kappa = 0.41
    u_tau = u_tau_wall(comps, geom, nu)
    y_plus = y_wall * u_tau / (nu + 1e-20)
    f_mu = 1.0 - torch.exp(-torch.clamp(y_plus / 26.0, max=20.0))
    k = (u_tau ** 2 / np.sqrt(C_mu)) * f_mu ** 2
    k = torch.minimum(torch.clamp(k, min=1e-10), 10.0 * u_tau ** 2)
    omega = torch.sqrt(k) / (C_mu ** 0.25 * kappa
                             * torch.clamp(y_wall, min=1e-10))
    shape = tuple(geom.axes[a].n for a in range(3))
    dtype = comps[0].dtype
    return (k.expand(shape).to(dtype).contiguous(),
            omega.expand(shape).to(dtype).contiguous())


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
