"""Staggered-MAC spatial operators, O2 and O4 (port of
`cfdnn_tpu/ops/operators.py`).

Plain PyTorch functions on unique-DOF staggered tensors; ghosts are
materialized by the `ops.bc` pads. These are the port's single source of
truth, as the jnp operators are the reference's: the hand-written kernels
in `ops/kernels.py` are tested against them. `tests/test_torch_ops.py`
holds each one to the reference at float64 roundoff.

With `space_order=4` the O4 stencils (f2c_mean4 ... same_diff2_4) take
the place of the O2 ones on each `Geometry.use_o4` axis (periodic,
uniform, n >= 4) in the advecting velocity, central convection,
scalar-nu diffusion, the divergence, the pressure gradient and the
Laplacian; skew convection, variable-nu diffusion and the velocity
gradient stay O2 at every order, as in the reference. The upwind and
upwind2 schemes take the O4 advecting velocity on O4 axes and their own
one-sided derivatives at every order, as in the reference.

Component/axis convention: comps = (u, v, w); component c is staggered along
axis c ("s" below); "d" ranges over the three derivative directions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import BCType, ConvectiveScheme
from .bc import face_pair, pad_center, pad_normal, pad_pressure, pad_tangential, sl
from .grid import AxisGeom, Geometry

Tensor = torch.Tensor
Vel = Tuple[Tensor, Tensor, Tensor]


# ---------------------------------------------------------------------------
# Primitive interpolation / differentiation helpers
# ---------------------------------------------------------------------------


def _R(f: Tensor, n: int, axis: int) -> Tensor:
    """Element i+n of a periodic array."""
    return torch.roll(f, -n, dims=axis)


def ax_of(b: Tensor) -> int:
    """Axis a broadcast-shaped (1,N,1)-style array varies along."""
    for i, s in enumerate(b.shape):
        if s > 1:
            return i
    return 0


def _stored_faces(x: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    """Slice an (N+1)-face array to the stored-face count (N if periodic)."""
    return sl(x, axis, 0, -1) if ax.periodic else x


def _inv_dpos_c(ax: AxisGeom) -> Tensor:
    """1/(ghost-aware center spacing) at all N+1 faces.

    Interior faces equal 1/dc; boundary faces use the mirrored-ghost distance
    (so a wall-tangential derivative across the wall face is exact no-slip).
    """
    p = ax.pos_c_pad
    a = ax_of(p)
    return 1.0 / (sl(p, a, 1, None) - sl(p, a, 0, -1))


def f2c_mean(f: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    lo, hi = face_pair(f, axis, ax.bc)
    return 0.5 * (lo + hi)


def f2c_diff(f: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    lo, hi = face_pair(f, axis, ax.bc)
    return (hi - lo) * ax.inv_d


def c2f_mean(fc: Tensor, axis: int, ax: AxisGeom, kind: str = "vel",
             wall=(0.0, 0.0)) -> Tensor:
    """Cell-centered -> stored faces, arithmetic mean.

    `wall`: tangential wall velocity pair for kind="vel".
    """
    if ax.bc == BCType.PERIODIC:
        return 0.5 * (_R(fc, -1, axis) + fc)
    pad = (pad_tangential(fc, axis, ax.bc, wall=wall) if kind == "vel"
           else pad_center(fc, axis, ax.bc, kind="neumann"))
    avg = 0.5 * (sl(pad, axis, 0, -1) + sl(pad, axis, 1, None))
    return _stored_faces(avg, axis, ax)


def c2f_diff(fc: Tensor, axis: int, ax: AxisGeom, kind: str = "vel",
             wall=(0.0, 0.0)) -> Tensor:
    """Cell-centered -> derivative at stored faces (ghost-aware spacing)."""
    inv_sp = _inv_dpos_c(ax)
    if ax.bc == BCType.PERIODIC:
        a = ax_of(inv_sp)
        return (fc - _R(fc, -1, axis)) * sl(inv_sp, a, 0, -1)
    pad = (pad_tangential(fc, axis, ax.bc, wall=wall) if kind == "vel"
           else pad_center(fc, axis, ax.bc, kind="neumann"))
    g = (sl(pad, axis, 1, None) - sl(pad, axis, 0, -1)) * inv_sp
    return _stored_faces(g, axis, ax)


def cc_central(phi: Tensor, axis: int, ax: AxisGeom, wall=(0.0, 0.0)) -> Tensor:
    """Central derivative at centers of a field cell-centered along `axis`."""
    p = ax.pos_c_pad
    a = ax_of(p)
    den = sl(p, a, 2, None) - sl(p, a, 0, -2)
    if ax.bc == BCType.PERIODIC:
        return (_R(phi, 1, axis) - _R(phi, -1, axis)) / den
    pad = pad_tangential(phi, axis, ax.bc, wall=wall)
    return (sl(pad, axis, 2, None) - sl(pad, axis, 0, -2)) / den


def ff_central(phi: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    """Central derivative at stored faces of a field staggered along `axis`."""
    p = ax.pos_f_pad
    a = ax_of(p)
    den = sl(p, a, 2, None) - sl(p, a, 0, -2)
    if ax.bc == BCType.PERIODIC:
        return (_R(phi, 1, axis) - _R(phi, -1, axis)) / den
    pad = pad_normal(phi, axis, ax.bc)
    return (sl(pad, axis, 2, None) - sl(pad, axis, 0, -2)) / den


# ---------------------------------------------------------------------------
# O4 periodic-uniform stencils (on `Geometry.use_o4` axes), the reference's
# formulas and order of evaluation, divided by the host spacing h
# ---------------------------------------------------------------------------


def f2c_mean4(F: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    """O4 faces->cell i: (9(F_i+F_{i+1}) - (F_{i-1}+F_{i+2}))/16."""
    return (9.0 * (F + _R(F, 1, axis))
            - (_R(F, -1, axis) + _R(F, 2, axis))) / 16.0


def f2c_diff4(F: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    """O4 staggered d/dx at cell i: (27(F_{i+1}-F_i) - (F_{i+2}-F_{i-1}))/(24h)."""
    return (27.0 * (_R(F, 1, axis) - F)
            - (_R(F, 2, axis) - _R(F, -1, axis))) / (24.0 * ax.h)


def c2f_mean4(f: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    """O4 cells->face i: (9(f_{i-1}+f_i) - (f_{i-2}+f_{i+1}))/16."""
    return (9.0 * (_R(f, -1, axis) + f)
            - (_R(f, -2, axis) + _R(f, 1, axis))) / 16.0


def c2f_diff4(f: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    """O4 staggered d/dx at face i: (27(f_i-f_{i-1}) - (f_{i+1}-f_{i-2}))/(24h)."""
    return (27.0 * (f - _R(f, -1, axis))
            - (_R(f, 1, axis) - _R(f, -2, axis))) / (24.0 * ax.h)


def same_diff4(f: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    """O4 collocated d/dx: (8(f_{i+1}-f_{i-1}) - (f_{i+2}-f_{i-2}))/(12h)."""
    return (8.0 * (_R(f, 1, axis) - _R(f, -1, axis))
            - (_R(f, 2, axis) - _R(f, -2, axis))) / (12.0 * ax.h)


def same_diff2_4(f: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    """O4 collocated d2/dx2: (-f_{i+2}+16f_{i+1}-30f_i+16f_{i-1}-f_{i-2})/(12h^2)."""
    return (-_R(f, 2, axis) + 16.0 * _R(f, 1, axis) - 30.0 * f
            + 16.0 * _R(f, -1, axis) - _R(f, -2, axis)) / (12.0 * ax.h**2)


def _minmod(a: Tensor, b: Tensor) -> Tensor:
    same = a * b > 0.0
    pick = torch.where(torch.abs(a) < torch.abs(b), a, b)
    return torch.where(same, pick, torch.zeros_like(pick))


def _upwind_pair(pad, pos, axis, a):
    """(backward, forward) one-sided derivatives from a 1-ghost pad."""
    num_b = sl(pad, axis, 1, -1) - sl(pad, axis, 0, -2)
    num_f = sl(pad, axis, 2, None) - sl(pad, axis, 1, -1)
    den_b = sl(pos, a, 1, -1) - sl(pos, a, 0, -2)
    den_f = sl(pos, a, 2, None) - sl(pos, a, 1, -1)
    return num_b / den_b, num_f / den_f


def _upwind2_deriv_pair(f_m2, f_m1, f_0, f_p1, f_p2, h_b, h_f):
    """(backward, forward) minmod-limited 2nd-order upwind derivatives,
    as the difference of MUSCL face reconstructions:

      backward: [ (f_0 + s_0/2) - (f_m1 + s_m1/2) ] / h_b
      forward:  [ (f_p1 - s_p1/2) - (f_0 - s_0f/2) ] / h_f

    with minmod-limited cell slopes s (the reference's formula, not the
    C++ code's inconsistent increment: PARITY.md)."""
    d_m1 = f_m1 - f_m2
    d_0 = f_0 - f_m1
    d_p1 = f_p1 - f_0
    d_p2 = f_p2 - f_p1
    back = (d_0 + 0.5 * (_minmod(d_p1, d_0) - _minmod(d_0, d_m1))) / h_b
    fwd = (d_p1 - 0.5 * (_minmod(d_p2, d_p1) - _minmod(d_p1, d_0))) / h_f
    return back, fwd


def _upwind2_pair(pad2, pos2, axis, a):
    """(backward, forward) limited 2nd-order upwind derivatives from a
    2-ghost pad, with local spacings on stretched axes."""
    f_m2 = sl(pad2, axis, 0, -4)
    f_m1 = sl(pad2, axis, 1, -3)
    f_0 = sl(pad2, axis, 2, -2)
    f_p1 = sl(pad2, axis, 3, -1)
    f_p2 = sl(pad2, axis, 4, None)
    h_b = sl(pos2, a, 2, -2) - sl(pos2, a, 1, -3)
    h_f = sl(pos2, a, 3, -1) - sl(pos2, a, 2, -2)
    return _upwind2_deriv_pair(f_m2, f_m1, f_0, f_p1, f_p2, h_b, h_f)


def _upwind_pair_periodic(f, pos, axis, a):
    """_upwind_pair on same-extent roll neighbors (periodic axes)."""
    f_m1 = _R(f, -1, axis)
    f_p1 = _R(f, 1, axis)
    den_b = sl(pos, a, 1, -1) - sl(pos, a, 0, -2)
    den_f = sl(pos, a, 2, None) - sl(pos, a, 1, -1)
    return (f - f_m1) / den_b, (f_p1 - f) / den_f


def _upwind2_pair_periodic(f, pos2, axis, a):
    """_upwind2_pair on same-extent roll neighbors (periodic axes)."""
    f_m2 = _R(f, -2, axis)
    f_m1 = _R(f, -1, axis)
    f_p1 = _R(f, 1, axis)
    f_p2 = _R(f, 2, axis)
    h_b = sl(pos2, a, 2, -2) - sl(pos2, a, 1, -3)
    h_f = sl(pos2, a, 3, -1) - sl(pos2, a, 2, -2)
    return _upwind2_deriv_pair(f_m2, f_m1, f, f_p1, f_p2, h_b, h_f)


# ---------------------------------------------------------------------------
# Convective term
# ---------------------------------------------------------------------------


def _advecting_velocity(comps: Vel, s: int, d: int, geom: Geometry) -> Tensor:
    """Component d interpolated to the DOF points of component s (4-pt avg;
    the O4 interpolation along each O4 axis)."""
    if d == s:
        return comps[s]
    if geom.use_o4(d):
        uc = f2c_mean4(comps[d], d, geom.axes[d])
    else:
        uc = f2c_mean(comps[d], d, geom.axes[d])
    if geom.use_o4(s):
        return c2f_mean4(uc, s, geom.axes[s])
    return c2f_mean(uc, s, geom.axes[s], kind="vel",
                    wall=geom.axes[s].tang[d])


def _conv_advective(comps: Vel, s: int, geom: Geometry,
                    scheme: ConvectiveScheme) -> Tensor:
    """Advective form u.grad(phi): central derivatives, or the one-sided
    pair of the upwind schemes chosen by the sign of the advecting
    velocity (a tie takes the backward one)."""
    if scheme == ConvectiveScheme.SKEW:
        raise ValueError("the advective form is not the skew scheme: "
                         "convective() routes skew to _conv_skew")
    phi = comps[s]
    out = torch.zeros_like(phi)
    for d in range(3):
        ax = geom.axes[d]
        if ax.n == 1:
            continue
        adv = _advecting_velocity(comps, s, d, geom)
        if scheme == ConvectiveScheme.CENTRAL:
            if geom.use_o4(d):
                dphi = same_diff4(phi, d, ax)
            else:
                dphi = (ff_central(phi, d, ax) if d == s
                        else cc_central(phi, d, ax, wall=ax.tang[s]))
        else:
            ng = 2 if scheme == ConvectiveScheme.UPWIND2 else 1
            if d == s:
                pos = ax.pos_f_pad2 if ng == 2 else ax.pos_f_pad
            else:
                pos = ax.pos_c_pad2 if ng == 2 else ax.pos_c_pad
            a = ax_of(pos)
            if ax.bc == BCType.PERIODIC:
                if ng == 2:
                    back, fwd = _upwind2_pair_periodic(phi, pos, d, a)
                else:
                    back, fwd = _upwind_pair_periodic(phi, pos, d, a)
            else:
                pad = (pad_normal(phi, d, ax.bc, ng=ng) if d == s
                       else pad_tangential(phi, d, ax.bc, ng=ng,
                                           wall=ax.tang[s]))
                if ng == 2:
                    back, fwd = _upwind2_pair(pad, pos, d, a)
                else:
                    back, fwd = _upwind_pair(pad, pos, d, a)
            dphi = torch.where(adv >= 0.0, back, fwd)
        out = out + adv * dphi
    return out


def _periodic_bdiff(F: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    """(F_i - F_{i-1}) * inv_dc with wrap — the shared periodic
    backward-difference of _bdiff_stored AND pressure_grad_face (the
    two must stay identical for D.G = L projection consistency)."""
    a = ax_of(ax.inv_dc)
    return (F - _R(F, -1, axis)) * sl(ax.inv_dc, a, 0, -1)


def _bdiff_stored(F: Tensor, axis: int, ax: AxisGeom) -> Tensor:
    """(F_i - F_{i-1}) * inv_dc at the stored faces of a cell-centered F
    (neumann ghosts)."""
    if ax.bc == BCType.PERIODIC:
        return _periodic_bdiff(F, axis, ax)
    pad = pad_center(F, axis, ax.bc, kind="neumann")
    g = (sl(pad, axis, 1, None) - sl(pad, axis, 0, -1)) * ax.inv_dc
    return _stored_faces(g, axis, ax)


def _conv_skew(comps: Vel, s: int, geom: Geometry) -> Tensor:
    """Exactly energy-conserving skew form.

    For each control-volume face pair of phi,
        N(phi) = (u_f_hi * phi_nb_hi - u_f_lo * phi_nb_lo) / (2 W)
    with u_f the advecting velocity interpolated to the CV face and W the CV
    width. The flux telescopes, so sum_cells V * phi * N(phi) == 0 to
    roundoff for any velocity field and stretching.
    """
    phi = comps[s]
    axs = geom.axes[s]
    out = torch.zeros_like(phi)
    for d in range(3):
        ax = geom.axes[d]
        if ax.n == 1:
            continue
        if d == s:
            phi_c = f2c_mean(phi, s, axs)                 # u_f at CV faces
            if axs.bc == BCType.PERIODIC:
                u_lo = _R(phi_c, -1, s)
                u_hi = phi_c
                lo_n = _R(phi, -1, s)
                hi_n = _R(phi, 1, s)
            else:
                cpad = pad_center(phi_c, s, axs.bc, kind="neumann")
                u_lo = _stored_faces(sl(cpad, s, 0, -1), s, axs)
                u_hi = _stored_faces(sl(cpad, s, 1, None), s, axs)
                npad = pad_normal(phi, s, axs.bc)
                lo_n = sl(npad, s, 0, -2)
                hi_n = sl(npad, s, 2, None)
            inv_w = _stored_faces(axs.inv_dc, ax_of(axs.inv_dc), axs)
            out = out + 0.5 * (u_hi * hi_n - u_lo * lo_n) * inv_w
        else:
            U_e = c2f_mean(comps[d], s, axs, kind="vel",  # at CV faces (edges)
                           wall=axs.tang[d])
            u_lo, u_hi = face_pair(U_e, d, ax.bc)
            if ax.bc == BCType.PERIODIC:
                lo_n = _R(phi, -1, d)
                hi_n = _R(phi, 1, d)
            else:
                tpad = pad_tangential(phi, d, ax.bc, wall=ax.tang[s])
                lo_n = sl(tpad, d, 0, -2)
                hi_n = sl(tpad, d, 2, None)
            out = out + 0.5 * (u_hi * hi_n - u_lo * lo_n) * ax.inv_d
    return out


def convective(comps: Vel, geom: Geometry,
               scheme: ConvectiveScheme = ConvectiveScheme.CENTRAL) -> Vel:
    """Convective term for each momentum component at its own DOF points:
    central, upwind and upwind2 are the advective form u.grad(phi), skew
    the exactly energy-conserving telescoping form (see _conv_skew)."""
    out = []
    for s in range(3):
        if scheme == ConvectiveScheme.SKEW:
            out.append(_conv_skew(comps, s, geom))
        else:
            out.append(_conv_advective(comps, s, geom, scheme))
    return tuple(out)


# ---------------------------------------------------------------------------
# Diffusive term (Laplacian form, variable viscosity)
# ---------------------------------------------------------------------------


def diffusive(comps: Vel, nu_center, geom: Geometry, skip_y: bool = False) -> Vel:
    """div(nu grad(phi)) per component with corner-averaged viscosity.

    `nu_center` is a scalar (a Python float or a 0-d tensor) or a cell
    field (Nx, Ny, Nz). A cell field is taken directly at the cells along
    phi's own axis and averaged to the transverse faces, flux direction
    first, then phi's axis. `skip_y` omits the y-direction term (implicit
    y-diffusion). A scalar nu takes the O4 second difference along each
    O4 axis; a cell field stays O2 at every order, as in the reference.
    """
    scalar_nu = not torch.is_tensor(nu_center) or nu_center.ndim == 0
    out = []
    for s in range(3):
        phi = comps[s]
        axs = geom.axes[s]
        term = torch.zeros_like(phi)
        for d in range(3):
            ax = geom.axes[d]
            if ax.n == 1 or (skip_y and d == 1):
                continue
            if scalar_nu and geom.use_o4(d):
                term = term + nu_center * same_diff2_4(phi, d, ax)
                continue
            if d == s:
                F = nu_center * f2c_diff(phi, s, axs)
                term = term + _bdiff_stored(F, s, axs)
            else:
                g_f = c2f_diff(phi, d, ax, kind="vel", wall=ax.tang[s])
                if scalar_nu:
                    nu_e = nu_center
                else:
                    nu_e = c2f_mean(c2f_mean(nu_center, d, ax, kind="scalar"),
                                    s, axs, kind="scalar")
                F = nu_e * g_f
                lo, hi = face_pair(F, d, ax.bc)
                term = term + (hi - lo) * ax.inv_d
        out.append(term)
    return tuple(out)


# ---------------------------------------------------------------------------
# Divergence / projection pieces
# ---------------------------------------------------------------------------


def divergence(comps: Vel, geom: Geometry) -> Tensor:
    """Staggered cell divergence."""
    div = None
    for axis in range(3):
        ax = geom.axes[axis]
        if ax.n == 1:
            continue
        if geom.use_o4(axis):
            t = f2c_diff4(comps[axis], axis, ax)
        else:
            lo, hi = face_pair(comps[axis], axis, ax.bc)
            t = (hi - lo) * ax.inv_d
        div = t if div is None else div + t
    return div


def pressure_grad_face(p: Tensor, axis: int, geom: Geometry) -> Tensor:
    """dp/dx_axis at the stored faces of the normal velocity component.

    Uses the Neumann mirror ghost so wall boundary faces get exactly zero
    gradient; interior faces use the same 1/dc spacings as the consistent
    Laplacian metrics, which makes the projection exact (D.G = L) on
    stretched grids.
    """
    ax = geom.axes[axis]
    if geom.use_o4(axis):
        return c2f_diff4(p, axis, ax)
    if ax.bc == BCType.PERIODIC:
        return _periodic_bdiff(p, axis, ax)
    pad = pad_pressure(p, axis, ax)
    g = (sl(pad, axis, 1, None) - sl(pad, axis, 0, -1)) * ax.inv_dc
    return _stored_faces(g, axis, ax)


def correct_velocity(comps: Vel, p_corr: Tensor, dt, geom: Geometry) -> Vel:
    """u <- u* - dt grad(p')."""
    out = []
    for axis in range(3):
        f = comps[axis]
        if geom.axes[axis].n == 1:
            out.append(f)
            continue
        out.append(f - dt * pressure_grad_face(p_corr, axis, geom))
    return tuple(out)


def laplacian(p: Tensor, geom: Geometry) -> Tensor:
    """Consistent scalar Laplacian L = D(G(p)) used by the Poisson solver."""
    lap = None
    for axis in range(3):
        ax = geom.axes[axis]
        if ax.n == 1:
            continue
        g = pressure_grad_face(p, axis, geom)
        if geom.use_o4(axis):
            t = f2c_diff4(g, axis, ax)
        else:
            lo, hi = face_pair(g, axis, ax.bc)
            t = (hi - lo) * ax.inv_d
        lap = t if lap is None else lap + t
    return lap


# ---------------------------------------------------------------------------
# Velocity gradient tensor (for turbulence closures)
# ---------------------------------------------------------------------------


def velocity_gradient(comps: Vel, geom: Geometry):
    """9-component grad(u) at cell centers: G[i][j] = d u_i / d x_j, each
    (Nx, Ny, Nz). The diagonal is the staggered difference; off the
    diagonal, the central difference at phi's own points, then the mean
    to the cell along phi's staggered axis."""
    shape = tuple(ax.n for ax in geom.axes)
    G = [[None] * 3 for _ in range(3)]
    for i in range(3):
        phi = comps[i]
        axi = geom.axes[i]
        for j in range(3):
            ax = geom.axes[j]
            if ax.n == 1:
                G[i][j] = torch.zeros(shape, dtype=phi.dtype,
                                      device=phi.device)
            elif i == j:
                G[i][j] = f2c_diff(phi, i, axi)
            else:
                d = cc_central(phi, j, ax, wall=ax.tang[i])
                G[i][j] = f2c_mean(d, i, axi)
    return G
