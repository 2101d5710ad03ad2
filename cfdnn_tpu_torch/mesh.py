"""Structured mesh with uniform x and uniform/tanh-stretched y,z.

A copy of `cfdnn_tpu/mesh.py` (pure NumPy), owned by the PyTorch port so
that it never imports the JAX package. Coordinates and metrics are
precomputed in float64 NumPy on the host; `ops.grid.Geometry` places them
on the Simulation's device in the working dtype. There are no ghost layers
in the stored state: ghost values are materialized inside the operators
from the BC spec.

Staggered MAC convention (reference: include/fields.hpp:12-222):
  - p[i,j,k] at cell centers (xc[i], yc[j], zc[k])
  - u[i,j,k] at x-faces  (xf[i], yc[j], zc[k])
  - v[i,j,k] at y-faces  (xc[i], yf[j], zc[k])
  - w[i,j,k] at z-faces  (xc[i], yc[j], zf[k])
Unique-DOF storage: along a periodic axis a normal-velocity component has N
faces (face N == face 0); along a wall axis it has N+1 faces with the boundary
faces carried in the array (v[:,0]=v[:,Ny]=0 for no-slip walls).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def tanh_stretching(N: int, lo: float, hi: float, beta: float) -> np.ndarray:
    """Face coordinates with tanh clustering toward both ends.

    y(s) = lo + L/2 * (1 + tanh(beta*(2s-1))/tanh(beta)), s in [0,1].
    Matches the reference's two-sided tanh law (src/mesh.cpp tanh_stretching).
    """
    s = np.linspace(0.0, 1.0, N + 1)
    L = hi - lo
    return lo + 0.5 * L * (1.0 + np.tanh(beta * (2.0 * s - 1.0)) / np.tanh(beta))


@dataclasses.dataclass
class Axis1D:
    """One mesh direction: faces, centers, spacings, Laplacian metrics."""

    n: int
    faces: np.ndarray      # (n+1,)
    centers: np.ndarray    # (n,)
    d: np.ndarray          # (n,)  cell widths: faces[j+1]-faces[j]
    dc: np.ndarray         # (n+1,) center-to-center distance at each face
                           #   interior face j: centers[j]-centers[j-1]
                           #   boundary faces: center-to-wall distance
    uniform: bool

    @classmethod
    def make(cls, n: int, lo: float, hi: float,
             stretch: bool = False, beta: float = 2.0) -> "Axis1D":
        if stretch and n > 1:
            faces = tanh_stretching(n, lo, hi, beta)
            uniform = False
        else:
            faces = np.linspace(lo, hi, n + 1)
            uniform = True
        ax = cls.from_faces(faces)
        ax.uniform = uniform   # exact flag, not from_faces' allclose guess
        return ax

    @classmethod
    def from_faces(cls, faces: np.ndarray) -> "Axis1D":
        """Axis from explicit (possibly stretched) face positions —
        used by the multigrid hierarchy, whose coarse levels drop every
        other face."""
        n = len(faces) - 1
        centers = 0.5 * (faces[:-1] + faces[1:])
        d = np.diff(faces)
        dc = np.empty(n + 1)
        dc[1:n] = centers[1:] - centers[:-1]
        dc[0] = centers[0] - faces[0]
        dc[n] = faces[n] - centers[n - 1]
        return cls(n=n, faces=faces, centers=centers, d=d, dc=dc,
                   uniform=bool(n <= 1 or np.allclose(d, d[0])))

    @property
    def lo(self) -> float:
        return float(self.faces[0])

    @property
    def hi(self) -> float:
        return float(self.faces[-1])

    @property
    def length(self) -> float:
        return self.hi - self.lo

    @property
    def h(self) -> float:
        """Uniform spacing (only meaningful when `uniform`)."""
        return float(self.d[0])

    def laplacian_metrics(self, periodic: bool, lo: str = "neumann",
                          hi: str = "neumann"):
        """Consistent D.G=L coefficients (aS, aP, aN) per cell.

        For cell j: L[p]_j = aS[j]*p[j-1] + aP[j]*p[j] + aN[j]*p[j+1] with the
        gradient evaluated at faces over `dc` and divergence over `d` — this is
        the reference's precomputed yLap_aS/aN/aP (include/mesh.hpp:16-182),
        which guarantees the projection is exact on stretched grids.

        Boundary handling per end (`lo`/`hi`): 'neumann' zeroes the
        boundary-face gradient; 'dirichlet' (value 0 at the wall face) uses the
        mirrored odd ghost, adding -2/(d*dist_ghost) to aP at that end.
        Periodic uses the wrap distance.
        """
        n, d, dc = self.n, self.d, self.dc.copy()
        if periodic:
            wrap = (self.centers[0] - self.faces[0]) + (self.faces[n] - self.centers[n - 1])
            dc[0] = dc[n] = wrap
        aS = (1.0 / (d * dc[:n])).copy()
        aN = (1.0 / (d * dc[1:])).copy()
        aP = -(aS + aN)
        if not periodic:
            # ghost distances (mirror): 2*(center-to-wall)
            g_lo = 2.0 * (self.centers[0] - self.faces[0])
            g_hi = 2.0 * (self.faces[-1] - self.centers[-1])
            # dirichlet (ghost = -p0 mirrored at g = 2*dc_boundary): the
            # ghost term 2/(d*g) equals aS/aN exactly because dc at the
            # boundary IS center-to-wall — Dirichlet leaves aP unchanged
            # while Neumann folds the boundary coefficient into aP. Keep
            # the identity checked so a change to from_faces' dc
            # convention cannot silently skew the boundary operator
            # (a raise, where the reference asserts: it survives -O).
            if (abs(aS[0] - 2.0 / (d[0] * g_lo)) > 1e-12 * aS[0]
                    or abs(aN[-1] - 2.0 / (d[-1] * g_hi)) > 1e-12 * aN[-1]):
                raise ValueError("laplacian_metrics: boundary dc is not "
                                 "the center-to-wall distance")
            if lo == "neumann":
                aP[0] += aS[0]
            aS[0] = 0.0
            if hi == "neumann":
                aP[-1] += aN[-1]
            aN[-1] = 0.0
        return aS, aP, aN


@dataclasses.dataclass
class Mesh:
    """Structured 2D/3D mesh (Nz=1 => 2D). Host-side; NumPy float64."""

    x: Axis1D
    y: Axis1D
    z: Axis1D

    @classmethod
    def from_config(cls, cfg) -> "Mesh":
        return cls(
            x=Axis1D.make(cfg.Nx, cfg.x_min, cfg.x_max),
            y=Axis1D.make(cfg.Ny, cfg.y_min, cfg.y_max, cfg.stretch_y, cfg.stretch_beta),
            z=Axis1D.make(cfg.Nz, cfg.z_min, cfg.z_max, cfg.stretch_z, cfg.stretch_beta_z),
        )

    @classmethod
    def uniform(cls, Nx, Ny, Nz=1, x=(0.0, 2 * np.pi), y=(-1.0, 1.0), z=(0.0, 1.0)):
        return cls(
            x=Axis1D.make(Nx, *x),
            y=Axis1D.make(Ny, *y),
            z=Axis1D.make(Nz, *z),
        )

    @property
    def Nx(self) -> int:
        return self.x.n

    @property
    def Ny(self) -> int:
        return self.y.n

    @property
    def Nz(self) -> int:
        return self.z.n

    @property
    def is_2d(self) -> bool:
        return self.z.n == 1

    @property
    def ncells(self) -> int:
        return self.x.n * self.y.n * self.z.n

    def wall_distance_y(self) -> np.ndarray:
        """Distance of each y-center to the nearest y wall (Ny,).

        Reference precomputes wall distance for algebraic closures
        (include/mesh.hpp wall-distance, used by mixing-length / SST F1/F2).
        """
        yc = self.y.centers
        return np.minimum(yc - self.y.lo, self.y.hi - yc)

    def min_spacing(self) -> float:
        h = [self.x.d.min(), self.y.d.min()]
        if not self.is_2d:
            h.append(self.z.d.min())
        return float(min(h))
