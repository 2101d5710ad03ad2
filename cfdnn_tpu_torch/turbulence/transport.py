"""Two-equation k-omega transport models: SST (Menter 1994) and standard
Wilcox k-omega (port of `cfdnn_tpu/turbulence/transport.py`).

One pass computes the gradients, the F1 blending, the limited production,
first-order upwind advection, conservative central diffusion, the
cross-diffusion term and the point-implicit destruction update for the
whole grid. Wall BCs (k = 0, omega at the wall 10 x 6 nu / (beta1 y1^2))
enter through ghost values.

The plain math (`sst_advance_math`, `sst_nut_math`, `komega_advance_math`)
is the single source of truth: the eager path runs it, and the
hand-written `transport` kernel of `ops/kernels.py` (csrc/transport.cu) is
held to it. Where the Simulation's kernel plan names that kernel
(`Simulation.kernels.closure == "transport"`), `advance` and
`advance_and_nu_t` launch it: SST with nu_t as a third output, SST with
two (the EARSM subclasses, whose own nu_t keeps the two-pass form), or
Wilcox with two. The clip and omega-pin epilogue runs after it, as in the
reference. Under implicit y-diffusion with a y wall (the IMEX branch of
`advance`) the plain math skips the y diffusion and k and omega are then
solved implicitly in y (`forcing.implicit_scalar_y_diffusion`, wall values
0 and omega_wall); the plan never names the kernel there, as the
reference never fuses it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import BCType
from ..forcing import implicit_scalar_y_diffusion
from ..ops import kernels
from ..ops.bc import sl
from ..ops.operators import _inv_dpos_c, ax_of
from ..utils.numerics import safe_tanh
from .base import (TurbulenceModelBase, cell_center_velocity,
                   k_omega_channel_estimate, strain_rotation,
                   wall_distance_host)


@dataclasses.dataclass(frozen=True)
class SSTConstants:
    """Menter SST constants."""

    sigma_k1: float = 0.85
    sigma_omega1: float = 0.5
    beta1: float = 0.075
    alpha1: float = 5.0 / 9.0
    sigma_k2: float = 1.0
    sigma_omega2: float = 0.856
    beta2: float = 0.0828
    alpha2: float = 0.44
    beta_star: float = 0.09
    a1: float = 0.31
    kappa: float = 0.41
    CD_omega_min: float = 1e-10
    k_min: float = 1e-10
    omega_min: float = 1e-10
    k_max: float = 100.0
    omega_max: float = 1e8


@dataclasses.dataclass(frozen=True)
class KOmegaConstants:
    """Wilcox 1988 constants."""

    sigma_k: float = 0.5
    sigma_omega: float = 0.5
    beta: float = 0.075
    beta_star: float = 0.09
    alpha: float = 5.0 / 9.0
    k_min: float = 1e-10
    omega_min: float = 1e-10
    k_max: float = 100.0
    omega_max: float = 1e8


# ---------------------------------------------------------------------------
# Scalar-transport operator helpers (ghost-aware, stretched-capable)
# ---------------------------------------------------------------------------


def _neighbors(f, axis, ax, wall_value):
    """Neighbour values (f_{i-1}, f_{i+1}) with ghost-aware boundary
    fixups, the same extent as f. Periodic wrap (even on a stretched
    axis); wall: Dirichlet `wall_value` at the wall face (ghost =
    2 v - interior); else (wall_value None at a wall) mirror."""
    if ax.bc == BCType.PERIODIC:
        return torch.roll(f, 1, axis), torch.roll(f, -1, axis)
    in_lo, in_hi = sl(f, axis, 0, 1), sl(f, axis, -1, None)
    if ax.bc == BCType.WALL and wall_value is not None:
        g_lo = 2.0 * wall_value - in_lo
        g_hi = 2.0 * wall_value - in_hi
    else:  # inflow/outflow or natural: zero-gradient
        g_lo, g_hi = in_lo, in_hi
    f_m = torch.cat([g_lo, sl(f, axis, 0, -1)], axis)
    f_p = torch.cat([sl(f, axis, 1, None), g_hi], axis)
    return f_m, f_p


def _axis_terms(f_m, f_p, f, axis, ax, vel_c):
    """(first-order upwind advection, central gradient) along `axis`, with
    the ghost-aware centre spacings of pos_c_pad."""
    pos = ax.pos_c_pad
    a = ax_of(pos)
    den_c = sl(pos, a, 2, None) - sl(pos, a, 0, -2)
    grad_c = (f_p - f_m) / den_c
    den_b = sl(pos, a, 1, -1) - sl(pos, a, 0, -2)
    den_f = sl(pos, a, 2, None) - sl(pos, a, 1, -1)
    back = (f - f_m) / den_b
    fwd = (f_p - f) / den_f
    adv = vel_c * torch.where(vel_c >= 0.0, back, fwd)
    return adv, grad_c


def _transport_terms(f, geom, vel_cc, wall_value):
    """Sum of the upwind advection over the axes, and the central
    gradients (zero along a one-cell axis)."""
    adv = torch.zeros_like(f)
    grads = []
    for axis in range(3):
        ax = geom.axes[axis]
        if ax.n <= 1:
            grads.append(torch.zeros_like(f))
            continue
        wv = wall_value if ax.bc == BCType.WALL else None
        f_m, f_p = _neighbors(f, axis, ax, wv)
        a, g = _axis_terms(f_m, f_p, f, axis, ax, vel_cc[axis])
        adv = adv + a
        grads.append(g)
    return adv, grads


def _diffusion(f, geom, nu_eff, wall_value, skip_y=False):
    """Conservative variable-coefficient diffusion div(nu_eff grad f):
    the face nu is the arithmetic mean of the two cells (mirror ghosts at
    a wall), the gradient takes the ghost-aware centre spacing. `skip_y`
    leaves out the y term (the IMEX branch solves it implicitly)."""
    out = torch.zeros_like(f)
    for axis in range(3):
        ax = geom.axes[axis]
        if ax.n <= 1 or (skip_y and axis == 1):
            continue
        wv = wall_value if ax.bc == BCType.WALL else None
        f_m, f_p = _neighbors(f, axis, ax, wv)
        n_m, n_p = _neighbors(nu_eff, axis, ax, None)   # mirror ghosts
        inv_dpos = _inv_dpos_c(ax)
        af = ax_of(inv_dpos)
        g_lo = (f - f_m) * sl(inv_dpos, af, 0, -1) * 0.5 * (n_m + nu_eff)
        g_hi = (f_p - f) * sl(inv_dpos, af, 1, None) * 0.5 * (nu_eff + n_p)
        out = out + (g_hi - g_lo) * ax.inv_d
    return out


def sst_advance_math(comps, k, om, nu_t, geom, nu, c, y_wall, om_wall,
                     dt, skip_y=False, return_sr=False):
    """The SST k/omega point-implicit update before the clip and pin
    epilogue: (k_new, om_new, nu_k, nu_om[, strain]). The single source of
    truth of the eager path and the transport kernel."""
    k = torch.clamp(k, min=c.k_min)
    om = torch.clamp(om, min=c.omega_min)
    nu_t = torch.clamp(nu_t, min=0.0)
    y = torch.clamp(y_wall, min=1e-10)

    vel_cc = cell_center_velocity(comps, geom)
    sr = strain_rotation(comps, geom)
    S2 = sr.S_mag ** 2

    adv_k, gk = _transport_terms(k, geom, vel_cc, 0.0)
    adv_om, gom = _transport_terms(om, geom, vel_cc, om_wall)

    # cross-diffusion and F1
    gkgo = sum(a * b for a, b in zip(gk, gom))
    CD_omega = torch.clamp(2.0 * c.sigma_omega2 / om * gkgo,
                           min=c.CD_omega_min)
    sqrt_k = torch.sqrt(k)
    arg1 = torch.maximum(sqrt_k / (c.beta_star * om * y),
                         500.0 * nu / (y * y * om))
    arg1 = torch.minimum(arg1,
                         4.0 * c.sigma_omega2 * k / (CD_omega * y * y))
    F1 = safe_tanh(arg1 ** 4)

    beta = F1 * c.beta1 + (1.0 - F1) * c.beta2
    alpha = F1 * c.alpha1 + (1.0 - F1) * c.alpha2
    sigma_k = F1 * c.sigma_k1 + (1.0 - F1) * c.sigma_k2
    sigma_om = F1 * c.sigma_omega1 + (1.0 - F1) * c.sigma_omega2

    nu_k = nu + sigma_k * nu_t
    nu_om = nu + sigma_om * nu_t

    # limited production, the standard Menter form P_k = nu_t S^2 with
    # S^2 = 2 S_ij S_ij (the reference's C++ code doubles it)
    P_k = torch.minimum(nu_t * S2, 10.0 * c.beta_star * k * om)
    CD = torch.clamp(2.0 * (1.0 - F1) * c.sigma_omega2 / om * gkgo, min=0.0)

    diff_k = _diffusion(k, geom, nu_k, 0.0, skip_y)
    diff_om = _diffusion(om, geom, nu_om, om_wall, skip_y)
    src_k = P_k + diff_k - adv_k
    src_om = alpha * (om / k) * P_k + diff_om - adv_om + CD
    k_new = (k + dt * src_k) / (1.0 + dt * c.beta_star * om)
    om_new = (om + dt * src_om) / (1.0 + dt * beta * om)
    if return_sr:
        return k_new, om_new, nu_k, nu_om, sr
    return k_new, om_new, nu_k, nu_om


def sst_nut_math(k, om, S_mag, y_wall, nu, c):
    """SST strain-limited eddy viscosity nu_t = a1 k / max(a1 om, |S| F2),
    clipped to [0, 1000 nu]."""
    k = torch.clamp(k, min=c.k_min)
    om = torch.clamp(om, min=c.omega_min)
    y = torch.clamp(y_wall, min=1e-10)
    arg2 = torch.maximum(2.0 * torch.sqrt(k) / (c.beta_star * om * y),
                         500.0 * nu / (y * y * om))
    F2 = safe_tanh(arg2 ** 2)
    nut = c.a1 * k / torch.maximum(c.a1 * om, S_mag * F2)
    return torch.clamp(nut, 0.0, 1000.0 * nu)


def sst_epilogue(k_new, om_new, c, pin=None, om_visc=None):
    """The clip of k and omega to their limits, then omega pinned to its
    viscous-sublayer value `om_visc` where `pin` > 0.5 (no pin without a
    wall). Idempotent."""
    k_new = torch.clamp(k_new, c.k_min, c.k_max)
    om_new = torch.clamp(om_new, c.omega_min, c.omega_max)
    if pin is not None:
        om_new = torch.where(pin > 0.5, om_visc, om_new)
    return k_new, om_new


def sst_with_nut_math(comps, k, om, nu_t, geom, nu, c, y_wall, om_wall, dt,
                      pin=None, om_visc=None):
    """The SST advance with the closure as a third output: (k_new, om_new)
    before the epilogue, and nu_t of the clipped and pinned k, omega from
    the same strain."""
    k_new, om_new, _, _, sr = sst_advance_math(
        comps, k, om, nu_t, geom, nu, c, y_wall, om_wall, dt, return_sr=True)
    k_c, om_c = sst_epilogue(k_new, om_new, c, pin, om_visc)
    return k_new, om_new, sst_nut_math(k_c, om_c, sr.S_mag, y_wall, nu, c)


def komega_advance_math(comps, k, om, nu_t, geom, nu, c, y_wall, om_wall,
                        dt, skip_y=False):
    """The Wilcox k-omega point-implicit update before the clip:
    (k_new, om_new, nu_k, nu_om). `y_wall` is taken for the calling
    convention of sst_advance_math (Wilcox has no wall blending)."""
    del y_wall
    k = torch.clamp(k, min=c.k_min)
    om = torch.clamp(om, min=c.omega_min)
    nu_t = torch.clamp(nu_t, min=0.0)

    vel_cc = cell_center_velocity(comps, geom)
    sr = strain_rotation(comps, geom)
    S2 = sr.S_mag ** 2

    adv_k, _ = _transport_terms(k, geom, vel_cc, 0.0)
    adv_om, _ = _transport_terms(om, geom, vel_cc, om_wall)

    nu_k = nu + c.sigma_k * nu_t
    nu_om = nu + c.sigma_omega * nu_t
    P_k = torch.minimum(nu_t * S2, 10.0 * c.beta_star * k * om)

    diff_k = _diffusion(k, geom, nu_k, 0.0, skip_y)
    diff_om = _diffusion(om, geom, nu_om, om_wall, skip_y)
    src_k = P_k + diff_k - adv_k
    src_om = c.alpha * (om / k) * P_k + diff_om - adv_om
    k_new = (k + dt * src_k) / (1.0 + dt * c.beta_star * om)
    om_new = (om + dt * src_om) / (1.0 + dt * c.beta * om)
    return k_new, om_new, nu_k, nu_om


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


class _TransportBase(TurbulenceModelBase):
    """Shared by SST and Wilcox: the wall distance on the device and, in
    the working dtype, on the host; the omega wall value; the kernel's
    per-cell constants; `initialize`."""

    kernel = "transport"
    # the beta of the omega wall value 10 x 6 nu / (beta y1^2)
    _wall_beta = "beta1"

    def __init__(self, cfg, mesh, geom, constants):
        self.c = constants
        self.nu = cfg.nu
        device = geom.axes[0].inv_d.device
        # host copy: every host scalar below comes from it, once, here
        self.y_wall_host = wall_distance_host(mesh, cfg, geom.dtype)
        self.y_wall = torch.as_tensor(self.y_wall_host, device=device)
        self.has_y_wall = cfg.bc_y == BCType.WALL
        self.has_wall = self.has_y_wall or (cfg.bc_z == BCType.WALL
                                            and mesh.Nz > 1)
        self.om_wall = None
        if self.has_wall:
            y1 = float(np.min(self.y_wall_host))
            beta = getattr(constants, self._wall_beta)
            self.om_wall = min(10.0 * 6.0 * self.nu / (beta * y1 * y1),
                               constants.omega_max)
        self._plane = (1, mesh.Ny, mesh.Nz)

    def _const(self, a):
        """A per-cell constant as the kernel takes it: (1, Ny, Nz),
        contiguous, in the working dtype."""
        return a.to(self.y_wall.dtype).expand(self._plane).contiguous()

    def initialize(self, state, sim):
        k, om = k_omega_channel_estimate(
            state.velocity, sim.geom, self.y_wall, self.nu,
            C_mu=self.c.beta_star)
        return state.replace(k=k, omega=om)

    def _nu_t_in(self, state):
        return (state.nu_t if state.nu_t is not None
                else torch.zeros_like(state.k))

    def _imex(self, sim) -> bool:
        """Whether the advance takes the IMEX branch: implicit
        y-diffusion with a y wall."""
        return bool(sim.cfg.implicit_y_diffusion) and self.has_y_wall

    def _plain_advance(self, math, state, sim, dt):
        """(k_new, om_new) of the plain math before the clip; under IMEX
        with the y diffusion left out of it and solved implicitly after
        (k to 0 and omega to omega_wall at the walls)."""
        imex = self._imex(sim)
        k_new, om_new, nu_k, nu_om = math(
            state.velocity, state.k, state.omega, self._nu_t_in(state),
            sim.geom, self.nu, self.c, self.y_wall, self.om_wall, dt,
            skip_y=imex)
        if imex:
            k_new = implicit_scalar_y_diffusion(k_new, nu_k, dt, sim.geom,
                                                0.0)
            om_new = implicit_scalar_y_diffusion(om_new, nu_om, dt,
                                                 sim.geom, self.om_wall)
        return k_new, om_new

    def _kernel(self, sim, state, dt, model):
        """The transport kernel on this state: 2 or 3 cell fields."""
        k = state.k
        return kernels.transport(
            *state.velocity, k, state.omega, self._nu_t_in(state),
            torch.as_tensor(dt, dtype=k.dtype, device=k.device),
            self.kernel_consts, sim.transport_arrays, geom=sim.geom,
            model=model, c=self.c, nu=self.nu, om_wall=self.om_wall)


class SSTTransport(_TransportBase):
    """SST k-omega transport and the SST strain-limited closure."""

    name = "SSTKOmega"

    def __init__(self, cfg, mesh, geom,
                 constants: SSTConstants = SSTConstants()):
        super().__init__(cfg, mesh, geom, constants)
        self.om_pin_mask = self.om_visc = None
        if self.has_wall:
            # Menter near-wall treatment: inside the viscous sublayer
            # omega is pinned to 6 nu / (beta1 y^2). The mask is the
            # wall-adjacent cells of each walled axis ((1, Ny, 1) without
            # a z wall), and the y+ < 3 band where the imposed pressure
            # gradient gives u_tau a priori.
            first = np.zeros((1, mesh.Ny, 1))
            if self.has_y_wall:
                first[:, 0, :] = first[:, -1, :] = 1.0
            if cfg.bc_z == BCType.WALL and mesh.Nz > 1:
                firstz = np.zeros((1, 1, mesh.Nz))
                firstz[:, :, 0] = firstz[:, :, -1] = 1.0
                first = first + firstz
            pin = first > 0
            if cfg.dp_dx != 0:
                u_tau_est = float(np.sqrt(abs(cfg.dp_dx) * 0.5 * cfg.Ly
                                          / cfg.rho))
                y_plus = self.y_wall_host * u_tau_est / cfg.nu
                pin = np.logical_or(y_plus < 3.0, pin)
            self.om_pin_mask = torch.as_tensor(pin, device=self.y_wall.device)
            self.om_visc = 6.0 * cfg.nu / (
                constants.beta1 * torch.clamp(self.y_wall, min=1e-12) ** 2)
        # the kernel's per-cell constants: y_wall [, pin mask, omega_visc]
        self.kernel_consts = (self._const(self.y_wall),)
        if self.has_wall:
            self.kernel_consts += (self._const(self.om_pin_mask),
                                   self._const(self.om_visc))

    def _epilogue(self, k_new, om_new):
        return sst_epilogue(k_new, om_new, self.c, self.om_pin_mask,
                            self.om_visc)

    def advance(self, state, sim, dt):
        if sim.kernels.closure == "transport":
            k_new, om_new = self._kernel(sim, state, dt, "sst")
        else:
            k_new, om_new = self._plain_advance(sst_advance_math, state,
                                                sim, dt)
        k_new, om_new = self._epilogue(k_new, om_new)
        return state.replace(k=k_new, omega=om_new)

    def nu_t(self, state, sim):
        sr = strain_rotation(state.velocity, sim.geom)
        return sst_nut_math(state.k, state.omega, sr.S_mag, self.y_wall,
                            self.nu, self.c)

    def advance_and_nu_t(self, state, sim, dt):
        """The advance and the closure in one kernel launch (nu_t a third
        output from the in-kernel strain), where the plan names the
        kernel and this model's nu_t is the SST closure (the EARSM
        subclasses keep the two-pass form)."""
        if (sim.kernels.closure != "transport"
                or type(self).nu_t is not SSTTransport.nu_t):
            return super().advance_and_nu_t(state, sim, dt)
        k_new, om_new, nut = self._kernel(sim, state, dt, "sst_nut")
        k_new, om_new = self._epilogue(k_new, om_new)
        return state.replace(k=k_new, omega=om_new), nut


class KOmegaTransport(_TransportBase):
    """Wilcox 1988 k-omega; nu_t = k / omega, clipped to [0, 1000 nu]."""

    name = "KOmega"
    # the Wilcox wall value shares the SST form with beta ~ beta1
    _wall_beta = "beta"

    def __init__(self, cfg, mesh, geom,
                 constants: KOmegaConstants = KOmegaConstants()):
        super().__init__(cfg, mesh, geom, constants)
        self.kernel_consts = (self._const(self.y_wall),)

    def advance(self, state, sim, dt):
        c = self.c
        if sim.kernels.closure == "transport":
            k_new, om_new = self._kernel(sim, state, dt, "komega")
        else:
            k_new, om_new = self._plain_advance(komega_advance_math, state,
                                                sim, dt)
        return state.replace(
            k=torch.clamp(k_new, c.k_min, c.k_max),
            omega=torch.clamp(om_new, c.omega_min, c.omega_max))

    def nu_t(self, state, sim):
        c = self.c
        k = torch.clamp(state.k, min=c.k_min)
        om = torch.clamp(state.omega, min=c.omega_min)
        return torch.clamp(k / om, 0.0, 1000.0 * self.nu)
