"""Direct-forcing immersed-boundary method (port of `cfdnn_tpu/ibm/forcing.py`).

The reference C++ code's IBMForcing (include/ibm_forcing.hpp:36-100,
src/ibm_forcing.cpp:56-230: classify_cells, compute_weights,
apply_forcing_device, mask_rhs_device). Face weights
  w = 1                 fluid            (phi > 0)
  w = clip(|phi|/band)  forcing band     (-band <= phi <= 0), band = 1.5 h
  w = 0                 solid            (phi < -band)
are computed on the host in NumPy float64, once per body, and moved to the
device in the working dtype once; `apply` is then an elementwise multiply
per component, and the force F = sum (1 - w) u dV / dt per component is one
product and one sum on the device (0-d tensors, never read on the host).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import BCType, Config
from ..mesh import Mesh
from .geometry import IBMBody

# the forcing band's width in local cell spacings (the reference's
# band_factor default, the reference C++ code's 1.5 h)
BAND_FACTOR = 1.5


class IBMForcing:
    """Weight-mask direct forcing bound to one (mesh, body), on one explicit
    torch device."""

    def __init__(self, mesh: Mesh, body: IBMBody, cfg: Config, *, device):
        self.body = body
        self.device = torch.device(device)
        dtype = getattr(torch, cfg.dtype)
        is2d = mesh.is_2d

        def on_device(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype,
                                   device=self.device)

        def local_band(axis_pts):
            """band = BAND_FACTOR * the LOCAL minimum cell spacing at each
            evaluation point (on a uniform mesh the reference C++ code's
            1.5 min(dx, dy, dz)): in a coarse region of a stretched mesh the
            global minimum would shrink the band below one local cell."""
            xs, ys, zs = axis_pts
            hx = np.interp(xs, mesh.x.centers, np.asarray(mesh.x.d))
            hy = np.interp(ys, mesh.y.centers, np.asarray(mesh.y.d))
            H = np.minimum(hx[:, None, None], hy[None, :, None])
            if not is2d:
                hz = np.interp(zs, mesh.z.centers, np.asarray(mesh.z.d))
                H = np.minimum(H, hz[None, None, :])
            return BAND_FACTOR * H

        # scalar upper bound on the band (the exact band on a uniform mesh)
        self.band = float(BAND_FACTOR * min(
            np.asarray(mesh.x.d).max(), np.asarray(mesh.y.d).max(),
            np.asarray(mesh.z.d).max() if not is2d else np.inf))

        def weights(axis_pts):
            xs, ys, zs = axis_pts
            X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
            phi = self.body.phi(X, Y, Z if not is2d else np.zeros_like(X))
            band = local_band(axis_pts)
            w = np.clip(np.abs(phi) / band, 0.0, 1.0)
            w = np.where(phi > 0.0, 1.0, w)
            w = np.where(phi < -band, 0.0, w)
            return w, phi, band

        def stored_faces(ax, bc):
            return ax.faces if bc != BCType.PERIODIC else ax.faces[:-1]

        xf = stored_faces(mesh.x, cfg.bc_x)
        yf = stored_faces(mesh.y, cfg.bc_y)
        zf = stored_faces(mesh.z, cfg.bc_z)
        xc, yc, zc = mesh.x.centers, mesh.y.centers, mesh.z.centers
        w_u = weights((xf, yc, zc))[0]
        w_v = weights((xc, yf, zc))[0]
        w_w = weights((xc, yc, zf))[0]
        _, phi_c, band_c = weights((xc, yc, zc))
        self.w_u, self.w_v, self.w_w = (on_device(w) for w in (w_u, w_v, w_w))
        # the solid cell centres, for the Poisson rhs (mask_rhs_device)
        self.fluid_cell = on_device(phi_c >= -band_c)
        # strictly-fluid cells one stencil halo beyond the forcing band:
        # direct forcing re-introduces divergence at the forced faces by
        # design, so solenoidality is only measured over this region; the
        # halo is the LOCAL cell size, as the band is
        local_h = np.maximum(np.asarray(mesh.x.d)[:, None, None],
                             np.asarray(mesh.y.d)[None, :, None])
        if not is2d:
            local_h = np.maximum(local_h,
                                 np.asarray(mesh.z.d)[None, None, :])
        self.fluid_interior = on_device(phi_c > band_c + local_h)
        self.n_solid = int(np.sum(phi_c < -band_c))
        self.n_forcing = int(np.sum((phi_c <= 0.0) & (phi_c >= -band_c)))

        # per-face control volumes of the force sums (a single mean dV is
        # wrong by the local-to-mean ratio on a stretched mesh)
        def face_d(ax, periodic):
            d = np.asarray(ax.d)
            if periodic:
                return 0.5 * (d + np.roll(d, 1))
            return np.concatenate([[0.5 * d[0]], 0.5 * (d[:-1] + d[1:]),
                                   [0.5 * d[-1]]])

        def volumes(dx, dy, dz):
            vol = dx.reshape(-1, 1, 1) * dy.reshape(1, -1, 1)
            return vol * (1.0 if dz is None else dz.reshape(1, 1, -1))

        dxc, dyc = np.asarray(mesh.x.d), np.asarray(mesh.y.d)
        dzc = None if is2d else np.asarray(mesh.z.d)
        dV_u = volumes(face_d(mesh.x, cfg.bc_x == BCType.PERIODIC), dyc, dzc)
        dV_v = volumes(dxc, face_d(mesh.y, cfg.bc_y == BCType.PERIODIC), dzc)
        dV_w = volumes(dxc, dyc, None if is2d
                       else face_d(mesh.z, cfg.bc_z == BCType.PERIODIC))
        # (1 - w) dV per face, formed once in float64: each force is then
        # one product with the velocity and one sum
        self._force_weights = tuple(
            on_device((1.0 - w) * dV)
            for w, dV in ((w_u, dV_u), (w_v, dV_v), (w_w, dV_w)))

    # -- step hooks ---------------------------------------------------------

    def apply(self, comps, dt=None, accumulate: bool = False):
        """u* <- w u* per component, and with `accumulate` (and a dt) the
        force sums F = sum (1 - w) u dV / dt, three 0-d tensors (the
        reference C++ code's apply_forcing_device accumulator,
        src/ibm_forcing.cpp:368-399). Returns (comps, forces or None)."""
        forces = None
        if accumulate and dt is not None:
            forces = tuple(torch.sum(f * c) / dt
                           for f, c in zip(self._force_weights, comps))
        u, v, w = comps
        return (u * self.w_u, v * self.w_v, w * self.w_w), forces

    def mask_rhs(self, rhs):
        """Zero the Poisson rhs in the solid cells (mask_rhs_device)."""
        return rhs * self.fluid_cell

    # -- diagnostics ----------------------------------------------------------

    def drag_lift_coefficients(self, forces: Tuple, u_ref: float,
                               length: float, span: float = 1.0):
        """Cd, Cl from the force sums: C = 2 F / (rho u_ref^2 L span) (the
        reference C++ code's app/main_cylinder.cpp output)."""
        fx, fy = forces[0], forces[1]
        denom = 0.5 * u_ref ** 2 * length * span
        return fx / denom, fy / denom
