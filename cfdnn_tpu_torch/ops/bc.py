"""Ghost-value materialization and velocity BC application
(port of `cfdnn_tpu/ops/bc.py`).

Operators call `pad_*`, which build the (N+2)-extended array on the fly
with `torch.cat`; the stored state carries no ghosts.

Ghost rules (2nd order):
  periodic          -> wrap
  cell 'neumann'    -> mirror value          (dp/dn = 0)
  cell 'dirichlet'  -> 2*g - interior        (value g at the wall face)
  tangential no-slip-> -interior             (u = 0 at the wall)
  normal face       -> boundary face stored; ghost = 2*f_bnd - f_next (odd)
  outflow           -> zero-gradient copy
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import BCType
from .grid import Geometry

__all__ = [
    "sl", "pad_center", "pad_pressure", "pad_tangential", "pad_normal",
    "face_pair", "apply_velocity_bc",
]


def sl(f, axis: int, start, stop=None, step=None):
    """Slice `f` along `axis`."""
    idx = [slice(None)] * f.ndim
    idx[axis] = slice(start, stop, step)
    return f[tuple(idx)]


def _cat(parts, axis):
    return torch.cat(parts, dim=axis)


def _flip(f, axis):
    return torch.flip(f, dims=(axis,))


def pad_center(f, axis: int, bc: BCType, value: float = 0.0,
               kind: str = "neumann", ng: int = 1):
    """Pad a cell-centered field with `ng` ghosts on each side.

    `kind` selects the wall rule: 'neumann' (mirror) or 'dirichlet' (value at
    the wall face). Periodic/outflow follow the BC type directly.
    """
    if bc == BCType.PERIODIC:
        return _cat([sl(f, axis, -ng, None), f, sl(f, axis, 0, ng)], axis)
    lo = _flip(sl(f, axis, 0, ng), axis)       # mirror: [f_{ng-1} .. f_0]
    hi = _flip(sl(f, axis, -ng, None), axis)
    if bc == BCType.OUTFLOW or (bc in (BCType.WALL, BCType.INFLOW) and kind == "neumann"):
        return _cat([lo, f, hi], axis)
    if bc == BCType.INFLOW:
        # an INFLOW axis is an asymmetric inlet/outlet pair: one Dirichlet
        # value cannot express it
        raise NotImplementedError(
            "pad_center(kind='dirichlet') on an INFLOW axis: the "
            "inlet/outlet pair needs per-end values; use kind='neumann' "
            "plus an explicit inlet-face overwrite")
    return _cat([2.0 * value - lo, f, 2.0 * value - hi], axis)


def pad_pressure(f, axis: int, ax):
    """1-ghost pad of the pressure with the axis's per-end BC kinds.

    The boundary-face gradient is divided by dc0 (face-to-center spacing),
    so the ghost sits AT the face: neumann => copy (zero gradient);
    dirichlet => 0 (the face value). This keeps the projection discretely
    consistent with the Poisson metrics (L = D.G).
    """
    if ax.bc == BCType.PERIODIC:
        return _cat([sl(f, axis, -1, None), f, sl(f, axis, 0, 1)], axis)
    lo = sl(f, axis, 0, 1)
    hi = sl(f, axis, -1, None)
    g_lo = torch.zeros_like(lo) if ax.p_lo == "dirichlet" else lo
    g_hi = torch.zeros_like(hi) if ax.p_hi == "dirichlet" else hi
    return _cat([g_lo, f, g_hi], axis)


def pad_tangential(f, axis: int, bc: BCType, ng: int = 1,
                   wall=(0.0, 0.0)):
    """Pad a velocity component along an axis it is cell-centered on.

    `wall`: (lo, hi) tangential wall velocity (AxisGeom.tang[comp]) —
    ghosts are the odd extension about the wall value, 2*value - interior.
    """
    if bc == BCType.PERIODIC:
        return _cat([sl(f, axis, -ng, None), f, sl(f, axis, 0, ng)], axis)
    lo = _flip(sl(f, axis, 0, ng), axis)
    hi = _flip(sl(f, axis, -ng, None), axis)
    if bc == BCType.WALL:
        if wall == (0.0, 0.0):                      # no-slip: value 0 at wall
            return _cat([-lo, f, -hi], axis)
        return _cat([2.0 * wall[0] - lo, f, 2.0 * wall[1] - hi], axis)
    # OUTFLOW / INFLOW default: zero-gradient
    return _cat([lo, f, hi], axis)


def pad_normal(f, axis: int, bc: BCType, ng: int = 1):
    """Pad a velocity component along its own (staggered) axis.

    Periodic: stored faces are 0..N-1, wrap. Wall: faces 0..N stored with the
    boundary faces in-array; ghosts are odd reflections about the boundary
    face (2*f_bnd - f_interior).
    """
    if bc == BCType.PERIODIC:
        return _cat([sl(f, axis, -ng, None), f, sl(f, axis, 0, ng)], axis)
    b_lo = sl(f, axis, 0, 1)
    b_hi = sl(f, axis, -1, None)
    if bc == BCType.OUTFLOW:
        lo = _cat([b_lo] * ng, axis)
        hi = _cat([b_hi] * ng, axis)
        return _cat([lo, f, hi], axis)
    lo = 2.0 * b_lo - _flip(sl(f, axis, 1, 1 + ng), axis)
    hi = 2.0 * b_hi - _flip(sl(f, axis, -1 - ng, -1), axis)
    return _cat([lo, f, hi], axis)


def face_pair(f, axis: int, bc: BCType) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) faces of every cell from a normal-velocity array.

    lo[i] = face i, hi[i] = face i+1 of cell i; N values each.
    """
    if bc == BCType.PERIODIC:
        return f, torch.roll(f, -1, dims=axis)
    return sl(f, axis, 0, -1), sl(f, axis, 1, None)


def apply_velocity_bc(u, v, w, geom: Geometry, convective_outlet=False):
    """Re-impose Dirichlet boundary-face values on wall/inflow axes.

    Only normal components store boundary faces; tangential wall conditions
    are enforced through ghosts at operator time. Returns new tensors (a
    changed component is copied first), so the inputs stay as they were
    and autograd sees no in-place write on them.
    """
    comps = [u, v, w]
    for axis in range(3):
        bc = geom.axes[axis].bc
        if bc == BCType.INFLOW and convective_outlet:
            continue
        if bc == BCType.WALL:
            f = comps[axis].clone()
            f.select(axis, 0).zero_()
            f.select(axis, -1).zero_()
            comps[axis] = f
        elif bc in (BCType.INFLOW, BCType.OUTFLOW):
            # zero-gradient outlet on the normal component's high face;
            # the inflow low face is imposed by the caller
            f = comps[axis].clone()
            f.select(axis, -1).copy_(f.select(axis, -2))
            if bc == BCType.OUTFLOW:
                f.select(axis, 0).copy_(f.select(axis, 1))
            comps[axis] = f
    return tuple(comps)
