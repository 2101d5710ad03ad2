"""LES subgrid-scale models: Smagorinsky, WALE, Vreman, Sigma, dynamic
Smagorinsky (port of `cfdnn_tpu/turbulence/les.py`).

Each closure's algebra is a plain PyTorch function of the cell strain
(`strain_rotation`) and the filter width; the same constants and floors as
the reference. Where the Simulation's kernel plan names one
(`Simulation.kernels.closure`), the step takes the hand-written kernel of
`ops/kernels.py` instead: `nu_sgs` for Smagorinsky, WALE and Vreman (the
closure a compile-time parameter of one CUDA kernel; `nu_sgs_xz`, the same
function on an (x, z) tile, in the plan's "xz" tiling), `germano_pass1`
for the dynamic model's first pass (in "xz" the plain chain, as the
reference's). Sigma runs plain, as in the reference (its
eigensolver needs arccos, which the reference's TPU kernel language
lacks).
"""

from __future__ import annotations

import math

import torch

from ..config import BCType
from ..ops import kernels
from .base import (TurbulenceModelBase, cell_center_velocity, filter_width,
                   strain_rotation)

# ---------------------------------------------------------------------------
# Closure algebra: (strain, filter width, constant) -> nu_sgs at the cells
# ---------------------------------------------------------------------------


def smagorinsky_nu(sr, delta, Cs):
    """nu_sgs = (Cs Delta)^2 |S|."""
    return (Cs * delta) ** 2 * sr.S_mag


def wale_nu(sr, delta, Cw):
    """Wall-Adapting Local Eddy viscosity (Nicoud & Ducros 1999):
    nu_sgs = (Cw D)^2 (Sd:Sd)^{3/2} / ((S:S)^{5/2} + (Sd:Sd)^{5/4}),
    Sd_ij = 0.5 (g_ik g_kj + g_jk g_ki) - (1/3) d_ij tr(g g)."""
    g = sr.G
    g2 = [[sum(g[i][m] * g[m][j] for m in range(3)) for j in range(3)]
          for i in range(3)]
    tr_g2 = g2[0][0] + g2[1][1] + g2[2][2]
    SdSd = 0.0
    for i in range(3):
        for j in range(3):
            Sd = 0.5 * (g2[i][j] + g2[j][i])
            if i == j:
                Sd = Sd - tr_g2 / 3.0
            SdSd = SdSd + Sd * Sd
    SS = 0.5 * sr.S_mag ** 2   # S:S = S_mag^2 / 2
    denom = SS ** 2.5 + SdSd ** 1.25 + 1e-30
    return (Cw * delta) ** 2 * SdSd ** 1.5 / denom


def vreman_nu(sr, delta, Cv):
    """Vreman (2004): nu_sgs = Cv sqrt(B_beta / (a:a)), a_ij = g_ji,
    beta = Delta^2 a^T a."""
    g = sr.G
    a = [[g[j][i] for j in range(3)] for i in range(3)]
    aa = sum(a[i][j] * a[i][j] for i in range(3) for j in range(3))
    d2 = delta * delta
    b = [[d2 * sum(a[m][i] * a[m][j] for m in range(3))
          for j in range(3)] for i in range(3)]
    Bb = (b[0][0] * b[1][1] - b[0][1] ** 2
          + b[0][0] * b[2][2] - b[0][2] ** 2
          + b[1][1] * b[2][2] - b[1][2] ** 2)
    Bb = torch.clamp(Bb, min=0.0)
    return Cv * torch.sqrt(Bb / torch.clamp(aa, min=1e-30))


# The closures the nu_sgs kernel carries, by the name the kernel takes, in
# the order of its CLOSURE template ids (csrc/nu_sgs.cu).
CLOSURES = {"smagorinsky": smagorinsky_nu, "wale": wale_nu,
            "vreman": vreman_nu}


def _sym3_eigvals(m11, m22, m33, m12, m13, m23):
    """Eigenvalues (descending) of a symmetric 3x3 field, analytic
    trigonometric method."""
    q = (m11 + m22 + m33) / 3.0
    d11, d22, d33 = m11 - q, m22 - q, m33 - q
    p2 = (d11 * d11 + d22 * d22 + d33 * d33
          + 2.0 * (m12 * m12 + m13 * m13 + m23 * m23))
    # dtype-aware floor: a literal 1e-60 underflows to 0 in float32, which
    # makes ip = inf and the eigenvalues NaN where the gradient is zero
    tiny = torch.finfo(p2.dtype).tiny * 1e6
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=tiny))
    ip = 1.0 / p
    b11, b22, b33 = d11 * ip, d22 * ip, d33 * ip
    b12, b13, b23 = m12 * ip, m13 * ip, m23 * ip
    detB = (b11 * (b22 * b33 - b23 * b23)
            - b12 * (b12 * b33 - b23 * b13)
            + b13 * (b12 * b23 - b22 * b13))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    # arccos via atan2, as the reference takes it
    phi = torch.atan2(torch.sqrt(torch.clamp(1.0 - r * r, min=0.0)), r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return e1, e2, e3


def sigma_nu(sr, delta, Cs):
    """Sigma model (Nicoud et al. 2011): nu_sgs = (Cs D)^2
    s3 (s1 - s2)(s2 - s3) / s1^2 with s1 >= s2 >= s3 the singular values
    of g."""
    g = sr.G
    m = [[sum(g[k][i] * g[k][j] for k in range(3)) for j in range(3)]
         for i in range(3)]
    e1, e2, e3 = _sym3_eigvals(m[0][0], m[1][1], m[2][2],
                               m[0][1], m[0][2], m[1][2])
    s1 = torch.sqrt(torch.clamp(e1, min=0.0))
    s2 = torch.sqrt(torch.clamp(e2, min=0.0))
    s3 = torch.sqrt(torch.clamp(e3, min=0.0))
    num = s3 * (s1 - s2) * (s2 - s3)
    return (Cs * delta) ** 2 * num / torch.clamp(s1 * s1, min=1e-30)


# ---------------------------------------------------------------------------
# Dynamic Smagorinsky: the test filter and the Germano products
# ---------------------------------------------------------------------------


def _box_filter_batch(fs, geom):
    """3-point box filter of a list of (Nx, Ny, Nz) fields along each
    non-trivial axis: periodic axes wrap; wall/inflow axes truncate and
    renormalize by the in-domain weight. Separable, so equal to the
    27-point box filter."""
    f = torch.stack(fs, dim=0)
    # the truncation weight is the same for every field: filter one
    # plane of ones and broadcast in the final divide
    w = torch.ones_like(f[:1])
    for sp in range(3):
        ax = geom.axes[sp]
        if ax.n <= 1:
            continue
        axis = sp + 1

        def smooth(x):
            if ax.bc == BCType.PERIODIC:
                lo = torch.roll(x, 1, axis)
                hi = torch.roll(x, -1, axis)
            else:
                n = x.shape[axis]
                zero = torch.zeros_like(x.narrow(axis, 0, 1))
                lo = torch.cat([zero, x.narrow(axis, 0, n - 1)], dim=axis)
                hi = torch.cat([x.narrow(axis, 1, n - 1), zero], dim=axis)
            return lo + x + hi

        f = smooth(f)
        w = smooth(w)
    out = f / w
    return [out[i] for i in range(len(fs))]


def germano_products(comps, geom):
    """(|S|, L:M, M:M) at the cells: L_ij = box(u_i u_j) - box(u_i)
    box(u_j) at the test filter, M_ij = 3 Delta^2 |S| S_ij, the
    off-diagonal pairs weighted 2."""
    sr = strain_rotation(comps, geom)
    delta = filter_width(geom)
    S, Sm = sr.S, sr.S_mag
    fac = 3.0 * delta * delta * Sm
    ucc = cell_center_velocity(comps, geom)
    pairs = [(i, j) for i in range(3) for j in range(i, 3)]
    filtered = _box_filter_batch(
        list(ucc) + [ucc[i] * ucc[j] for i, j in pairs], geom)
    ubar = filtered[:3]
    uubar = dict(zip(pairs, filtered[3:]))
    LM = torch.zeros_like(Sm)
    MM = torch.zeros_like(Sm)
    for i, j in pairs:
        wgt = 1.0 if i == j else 2.0
        Lij = uubar[(i, j)] - ubar[i] * ubar[j]
        Mij = fac * S[i][j]
        LM = LM + wgt * Lij * Mij
        MM = MM + wgt * Mij * Mij
    return Sm, LM, MM


def germano_nu_t(smag, lm, mm, delta):
    """The dynamic model's epilogue: Cs^2(y) = clip(<L:M> / <M:M>, 0, 0.5)
    from the (x, z)-plane sums lm, mm (1, Ny, 1); nu_sgs = Cs^2 Delta^2
    |S|."""
    ok = mm > 1e-30
    cs2 = torch.where(ok, lm / torch.where(ok, mm, torch.ones_like(mm)),
                      torch.zeros_like(lm))
    cs2 = torch.clamp(cs2, 0.0, 0.5)
    return cs2 * delta * delta * smag


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


class LESModelBase(TurbulenceModelBase):
    """Shared: velocity gradient -> per-cell nu_sgs. `closure` names the
    nu_sgs kernel's closure for the models it carries; `coeff` is the
    model constant (a keyword of the constructor)."""

    closure = None
    coeff = 0.0

    def __init__(self, cfg, mesh, geom, coeff=None):
        self.cfg = cfg
        if coeff is not None:
            self.coeff = coeff

    def _nu_sgs(self, sr, delta):
        return CLOSURES[self.closure](sr, delta, self.coeff)

    def _model_fn(self, comps, geom):
        return self._nu_sgs(strain_rotation(comps, geom), filter_width(geom))

    def nu_t(self, state, sim):
        comps = state.velocity
        if sim.kernels.closure in ("nu_sgs", "nu_sgs_xz"):
            kernel = (kernels.nu_sgs_xz if sim.kernels.closure == "nu_sgs_xz"
                      else kernels.nu_sgs)
            return kernel(*comps, sim.les_arrays, geom=sim.geom,
                          closure=self.closure, coeff=self.coeff)
        return self._model_fn(comps, sim.geom)


class SmagorinskyModel(LESModelBase):
    """nu_sgs = (Cs Delta)^2 |S|, Cs = 0.17."""

    name = "Smagorinsky"
    closure = "smagorinsky"
    kernel = "nu_sgs"
    coeff = 0.17


class WALEModel(LESModelBase):
    """WALE (see wale_nu), Cw = 0.325."""

    name = "WALE"
    closure = "wale"
    kernel = "nu_sgs"
    coeff = 0.325


class VremanModel(LESModelBase):
    """Vreman (see vreman_nu), Cv = 0.07."""

    name = "Vreman"
    closure = "vreman"
    kernel = "nu_sgs"
    coeff = 0.07


class SigmaModel(LESModelBase):
    """Sigma (see sigma_nu), Cs = 1.35; always plain, as in the reference
    (its eigensolver's arccos has no TPU kernel there)."""

    name = "Sigma"
    coeff = 1.35

    def _nu_sgs(self, sr, delta):
        return sigma_nu(sr, delta, self.coeff)


class DynamicSmagorinskyModel(LESModelBase):
    """Germano-identity dynamic model with (x, z)-plane Cs^2(y):
    L_ij = box(u_i u_j) - box(u_i) box(u_j) at test filter 2 Delta,
    M_ij = 3 Delta^2 |S| S_ij, Cs^2(y) = clip(<L:M>_xz / <M:M>_xz, 0, 0.5),
    nu_sgs = Cs^2(y) Delta^2 |S|."""

    name = "DynamicSmagorinsky"
    kernel = "germano_pass1"

    def nu_t(self, state, sim):
        comps = state.velocity
        if sim.kernels.closure == "germano_pass1":
            smag, lm, mm = kernels.germano_pass1(*comps, sim.les_arrays,
                                                 geom=sim.geom)
            # Delta: the kernels' own copy (les_arrays' last vector, the
            # (y, z) plane)
            delta = sim.les_arrays[-1].view(1, sim.geom.y.n, sim.geom.z.n)
            return germano_nu_t(smag, lm, mm, delta)
        return self._germano_nu_t_plain(comps, sim.geom)

    def _germano_nu_t_plain(self, comps, geom):
        """The plain two-pass chain, the plane sums in the field dtype as
        the reference's."""
        Sm, LM, MM = germano_products(comps, geom)
        lm = torch.sum(LM, dim=(0, 2), keepdim=True)
        mm = torch.sum(MM, dim=(0, 2), keepdim=True)
        return germano_nu_t(Sm, lm, mm, filter_width(geom))
