"""Explicit Algebraic Reynolds Stress Models on SST k-omega transport
(port of `cfdnn_tpu/turbulence/earsm.py`).

Anisotropy b_ij = sum_n G_n(eta, zeta) T^(n)_ij with the 2-D tensor basis
(T1 = S*, T2 = [S*, Omega*], T3 = S*^2 - tr/3), a smooth Re_t-tanh blending
of the nonlinear terms, Reynolds stresses tau_ij = 2 k (b_ij + delta_ij/3)
and an equivalent nu_t from the shear component. The (k, omega) transport
is SSTTransport's advance, through the `transport` kernel where the kernel
plan names it (SST math, two outputs); nu_t is this module's plain
pipeline, after the advance (the two-pass form).

The formulation is 2-D in the x-y plane: it takes the in-plane components
of the 3-D gradient tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.numerics import safe_tanh
from .base import strain_rotation
from .features import anisotropy_to_stress
from .transport import SSTConstants, SSTTransport


@dataclasses.dataclass(frozen=True)
class WJConstants:
    """Wallin-Johansson SSG pressure-strain constants."""

    C1: float = 1.8
    C1_star: float = 0.5
    C2: float = 0.36
    C3: float = 1.25
    C3_star: float = 0.4
    C4: float = 0.4
    C5: float = 1.88

    @property
    def A1(self):
        return 4.0 / 5.0 - self.C2 / 2.0

    @property
    def A2(self):
        return 2.0 - self.C4 / 2.0

    @property
    def A3(self):
        return 2.0 - self.C3 / 2.0

    @property
    def A4(self):
        return 2.0 * self.C5 - 1.0


@dataclasses.dataclass(frozen=True)
class GSConstants:
    """Gatski-Speziale constants."""

    C_mu: float = 0.09
    C1: float = 1.8
    C2: float = 0.6
    eta_max: float = 10.0


class EARSMBase(SSTTransport):
    """Shared EARSM pipeline; subclasses provide (G1, G2, G3)(eta, zeta)."""

    provides_reynolds_stresses = True
    C_MU = 0.09

    def __init__(self, cfg, mesh, geom,
                 constants: SSTConstants = SSTConstants()):
        super().__init__(cfg, mesh, geom, constants)
        self.Re_t_center = 10.0
        self.Re_t_width = 5.0

    def _G(self, eta, zeta):
        raise NotImplementedError

    def _pipeline(self, state, sim):
        """eta, zeta -> G -> b_ij -> (nu_t, tau)."""
        c = self.c
        k = torch.clamp(state.k, min=c.k_min)
        om = torch.clamp(state.omega, min=c.omega_min)
        sr = strain_rotation(state.velocity, sim.geom)
        # in-plane components (the 2-D formulation)
        Sxx, Sxy, Syy = sr.S[0][0], sr.S[0][1], sr.S[1][1]
        Oxy = sr.O12
        S_mag = torch.sqrt(2.0 * (Sxx ** 2 + Syy ** 2 + 2.0 * Sxy ** 2))
        # |Omega| = sqrt(2 O_ij O_ij) = 2 |Oxy| in-plane, the
        # normalisation of S_mag (in pure shear eta == zeta)
        O_mag = 2.0 * torch.abs(Oxy)

        # turbulence time scale tau = k / eps = 1 / (C_mu omega)
        tau = 1.0 / (self.C_MU * om)
        eta = torch.clamp(tau * S_mag, max=100.0)
        zeta = torch.clamp(tau * O_mag, max=100.0)

        G1, G2, G3 = (torch.clamp(g, -10.0, 10.0) for g in self._G(eta, zeta))

        # Re_t blending of the nonlinear terms
        Re_t = k / (self.nu * om)
        alpha = 0.5 * (1.0 + safe_tanh((Re_t - self.Re_t_center)
                                       / self.Re_t_width))
        G2 = G2 * alpha
        G3 = G3 * alpha

        # normalised tensors and the 2-D basis
        Ss_xx, Ss_xy, Ss_yy = tau * Sxx, tau * Sxy, tau * Syy
        Os_xy = tau * Oxy
        comm_xx = -2.0 * Ss_xy * Os_xy
        comm_xy = (Ss_xx - Ss_yy) * Os_xy
        comm_yy = 2.0 * Ss_xy * Os_xy
        S2_xx = Ss_xx ** 2 + Ss_xy ** 2
        S2_xy = Ss_xy * (Ss_xx + Ss_yy)
        S2_yy = Ss_xy ** 2 + Ss_yy ** 2
        tr = S2_xx + S2_yy
        S2_xx, S2_yy = S2_xx - tr / 3.0, S2_yy - tr / 3.0

        b_xx = G1 * Ss_xx + G2 * comm_xx + G3 * S2_xx
        b_xy = G1 * Ss_xy + G2 * comm_xy + G3 * S2_xy
        b_yy = G1 * Ss_yy + G2 * comm_yy + G3 * S2_yy

        tau_xx, tau_xy, tau_yy = anisotropy_to_stress(b_xx, b_xy, b_yy, k)

        # equivalent nu_t from tau_xy = -2 nu_t S_xy
        b_mag = torch.sqrt(b_xx ** 2 + 2.0 * b_xy ** 2 + b_yy ** 2)
        shear = torch.abs(Sxy) > 1e-10
        nut = torch.where(
            shear,
            torch.abs(-b_xy * k / torch.where(shear, Sxy,
                                              torch.ones_like(Sxy))),
            torch.where(S_mag > 1e-10,
                        k * b_mag / torch.clamp(S_mag, min=1e-10),
                        torch.zeros_like(S_mag)),
        )
        nut = torch.nan_to_num(torch.clamp(nut, 0.0, 100.0 * self.nu))
        return nut, (tau_xx, tau_xy, tau_yy)

    def nu_t(self, state, sim):
        return self._pipeline(state, sim)[0]

    def reynolds_stresses(self, state, sim):
        return self._pipeline(state, sim)[1]


def _cbrt(x):
    """Real cube root, sign kept (jnp.cbrt)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


class WallinJohanssonEARSM(EARSMBase):
    """Wallin-Johansson 2000 with the exact 2-D closed-form N: the root of
    N^3 - c1' N^2 - (2.7 II_S + 2 II_O) N + 2 c1' II_O = 0, well-posed for
    all invariants (N >= c1'/3 > 0, Q = N^2 - 2 II_O > 0), in place of the
    reference C++ code's simplified N = -A1 / (1 + A3 II_S + A4 II_O), which
    blows G1 up at weak strain."""

    name = "EARSM-WJ"

    def __init__(self, cfg, mesh, geom, wj: WJConstants = WJConstants(),
                 **kw):
        super().__init__(cfg, mesh, geom, **kw)
        self.wj = wj

    def _G(self, eta, zeta):
        # exact 2-D invariants: II_S = tr(S*^2) = eta^2 / 2 under the
        # S_mag = sqrt(2 S_ij S_ij) normalisation; II_O = tr(O*^2) <= 0
        II_S = 0.5 * eta * eta
        II_O = -0.5 * zeta * zeta
        c1p = 9.0 / 4.0 * (self.wj.C1 - 1.0)
        P1 = (c1p ** 2 / 27.0 + 0.45 * II_S - (2.0 / 3.0) * II_O) * c1p
        P2 = P1 ** 2 - (c1p ** 2 / 9.0 + 0.9 * II_S
                        + (2.0 / 3.0) * II_O) ** 3
        sqrtP2 = torch.sqrt(torch.clamp(P2, min=0.0))
        t1 = _cbrt(P1 + sqrtP2)
        arg = P1 - sqrtP2
        t2 = torch.sign(arg) * _cbrt(torch.abs(arg))
        N_pos = c1p / 3.0 + t1 + t2
        # P2 < 0: the strongly rotational branch (trigonometric root)
        base = torch.clamp(P1 ** 2 - P2, min=1e-30)
        theta = torch.atan2(torch.sqrt(torch.clamp(-P2, min=0.0)), P1)
        N_neg = c1p / 3.0 + 2.0 * base ** (1.0 / 6.0) * torch.cos(theta / 3.0)
        N = torch.where(P2 >= 0.0, N_pos, N_neg)
        Q = torch.clamp(N * N - 2.0 * II_O, min=1e-10)
        # b-convention (b = a / 2): G = beta_WJ / 2 = -(3/5) {N, 1} / Q
        G1 = -0.6 * N / Q
        G2 = -0.6 / Q
        G3 = torch.zeros_like(G1)   # the S^2 term vanishes in exact 2-D WJ
        return G1, G2, G3


class GatskiSpezialeEARSM(EARSMBase):
    """Gatski-Speziale 1993, regularised."""

    name = "EARSM-GS"

    def __init__(self, cfg, mesh, geom, gs: GSConstants = GSConstants(),
                 **kw):
        super().__init__(cfg, mesh, geom, **kw)
        self.gs = gs

    def _G(self, eta, zeta):
        g = self.gs
        C_mu_eff = g.C_mu / (1.0 + eta ** 2 / g.eta_max ** 2)
        ratio = torch.where(eta > 1e-10,
                            zeta / torch.clamp(eta, min=1e-10),
                            torch.zeros_like(eta))
        rot = 1.0 / (1.0 + 0.1 * ratio ** 2)
        G1 = -C_mu_eff * rot
        G2 = g.C1 * C_mu_eff ** 2
        G3 = g.C2 * C_mu_eff
        return tuple(torch.clamp(x, -5.0, 5.0) for x in (G1, G2, G3))


class PopeQuadraticEARSM(EARSMBase):
    """Pope 1975 quadratic."""

    name = "EARSM-Pope"

    def __init__(self, cfg, mesh, geom, C1: float = 0.1, C2: float = 0.1,
                 **kw):
        super().__init__(cfg, mesh, geom, **kw)
        self.C1 = C1
        self.C2 = C2

    def _G(self, eta, zeta):
        eta_safe = torch.clamp(torch.nan_to_num(eta, nan=100.0), max=100.0)
        C_mu_eff = self.C_MU / (1.0 + 0.01 * eta_safe ** 2)
        return -C_mu_eff, self.C2 * eta_safe, self.C1 * eta_safe
