"""Geometry constants for the operator layer (port of `cfdnn_tpu/ops/grid.py`).

Per axis, the spacings and positions used by the staggered stencils. They
are built in float64 NumPy on the host, as the reference builds them, and
then placed once as tensors on the Simulation's device in the working
dtype, broadcast-ready as (1, N, 1)-style shapes.

Axis indexing convention everywhere: axis 0 = x (i), 1 = y (j), 2 = z (k).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import BCType, Config, pressure_bc_kinds
from ..mesh import Mesh


def _bshape(a: np.ndarray, axis: int) -> Tuple[int, int, int]:
    s = [1, 1, 1]
    s[axis] = a.shape[0]
    return tuple(s)


def _sl1(a: torch.Tensor) -> torch.Tensor:
    """Drop the outermost ghost on the (single) non-unit axis."""
    idx = tuple(slice(1, -1) if s > 1 else slice(None) for s in a.shape)
    return a[idx]


@dataclasses.dataclass(frozen=True)
class AxisGeom:
    """Per-axis geometric constants, broadcast-ready ((1,N,1)-style)."""

    n: int
    bc: BCType
    periodic: bool
    uniform: bool
    h: float                 # uniform spacing (valid when uniform)
    length: float
    d: torch.Tensor          # (..N..)   cell widths
    inv_d: torch.Tensor
    dc: torch.Tensor         # (..N+1..) center-to-center distance at faces
    inv_dc: torch.Tensor     # with periodic wrap / boundary half-distances
    centers: torch.Tensor    # (..N..)
    faces: torch.Tensor      # (..N+1..)
    # 2-ghost padded DOF positions for derivative denominators
    pos_c_pad2: torch.Tensor  # (..N+4..) centers with 2 ghost-center coords/side
    pos_f_pad2: torch.Tensor  # (..Nf+4..) stored-face coords with 2 ghosts/side
    p_lo: str = "neumann"    # pressure BC kind at the low end —
    p_hi: str = "neumann"    # must match the Poisson backend exactly
    # Tangential wall velocity per velocity component, ((lo, hi) per comp):
    # WALL ghosts become 2*value - interior instead of -interior.
    tang: Tuple[Tuple[float, float], Tuple[float, float],
                Tuple[float, float]] = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
    # 24 h in each of the N entries where o4_ok, else None: the divisor of
    # the O4 staggered differences (f2c_diff4, c2f_diff4) as the
    # divergence and correct kernels read it
    o4_den: Optional[torch.Tensor] = None

    @property
    def o4_ok(self) -> bool:
        """O4 stencils apply on uniform periodic axes of n >= 4 (the
        reference's AxisGeom.o4_ok: wide stencils near walls would need
        one-sided closures)."""
        return self.periodic and self.uniform and self.n >= 4

    @property
    def pos_c_pad(self):
        """(..N+2..) 1-ghost center positions."""
        return _sl1(self.pos_c_pad2)

    @property
    def pos_f_pad(self):
        """(..Nf+2..) 1-ghost stored-face positions."""
        return _sl1(self.pos_f_pad2)

    @classmethod
    def make(cls, ax, bc: BCType, axis: int, dtype, device,
             p_kinds=("neumann", "neumann"),
             tang=((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))) -> "AxisGeom":
        n = ax.n
        periodic = bc == BCType.PERIODIC
        d = ax.d
        dc = ax.dc.copy()
        if periodic:
            wrap = (ax.centers[0] - ax.faces[0]) + (ax.faces[n] - ax.centers[n - 1])
            dc[0] = dc[n] = wrap
        c, L = ax.centers, ax.length
        if periodic:
            c_lo = c[-2:] - L
            c_hi = c[:2] + L
        else:
            # mirror about each wall face
            c_lo = (2.0 * ax.faces[0] - c[:2])[::-1]
            c_hi = (2.0 * ax.faces[-1] - c[-2:])[::-1]
        pos_c_pad2 = np.concatenate([c_lo, c, c_hi])
        if periodic:
            f = ax.faces[:n]
            f_lo = f[-2:] - L
            f_hi = f[:2] + L
        else:
            f = ax.faces
            f_lo = (2.0 * f[0] - f[1:3])[::-1]
            f_hi = (2.0 * f[-1] - f[-3:-1])[::-1]
        pos_f_pad2 = np.concatenate([f_lo, f, f_hi])

        def arr(a):
            return torch.as_tensor(np.ascontiguousarray(a).reshape(
                _bshape(a, axis)), dtype=dtype, device=device)

        return cls(
            n=n, bc=bc, periodic=periodic, uniform=ax.uniform,
            p_lo=p_kinds[0], p_hi=p_kinds[1], tang=tang,
            h=float(ax.d[0]), length=ax.length,
            d=arr(d), inv_d=arr(1.0 / d),
            dc=arr(dc), inv_dc=arr(1.0 / dc),
            centers=arr(ax.centers), faces=arr(ax.faces),
            pos_c_pad2=arr(pos_c_pad2), pos_f_pad2=arr(pos_f_pad2),
            o4_den=(arr(np.full(n, 24.0 * float(ax.d[0])))
                    if periodic and ax.uniform and n >= 4 else None),
        )


@dataclasses.dataclass(frozen=True)
class Geometry:
    """All per-axis constants; built once per (mesh, config, device)."""

    axes: Tuple[AxisGeom, AxisGeom, AxisGeom]
    dtype: torch.dtype
    space_order: int = 2     # 2 or 4 (O4 on o4_ok axes only)

    @classmethod
    def make(cls, mesh: Mesh, cfg: Config, *, device) -> "Geometry":
        """The geometry of `mesh` under `cfg`, as tensors on `device`
        (required: there is no default device)."""
        dtype = getattr(torch, cfg.dtype)
        return cls(
            axes=(
                AxisGeom.make(mesh.x, cfg.bc_x, 0, dtype, device,
                              pressure_bc_kinds(cfg, 0)),
                AxisGeom.make(mesh.y, cfg.bc_y, 1, dtype, device,
                              pressure_bc_kinds(cfg, 1),
                              tang=((0.0, float(cfg.lid_velocity)),
                                    (0.0, 0.0), (0.0, 0.0))),
                AxisGeom.make(mesh.z, cfg.bc_z, 2, dtype, device,
                              pressure_bc_kinds(cfg, 2)),
            ),
            dtype=dtype,
            space_order=cfg.space_order,
        )

    def use_o4(self, axis: int) -> bool:
        """Whether the O4 stencils apply along `axis`."""
        return self.space_order >= 4 and self.axes[axis].o4_ok

    @property
    def x(self) -> AxisGeom:
        return self.axes[0]

    @property
    def y(self) -> AxisGeom:
        return self.axes[1]

    @property
    def z(self) -> AxisGeom:
        return self.axes[2]
