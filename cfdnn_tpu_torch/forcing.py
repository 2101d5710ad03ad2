"""Implicit y-diffusion (port of `implicit_scalar_y_diffusion` and
`implicit_y_diffusion` of `cfdnn_tpu/forcing.py`).

Backward Euler in y of the viscous term, (I - dt d/dy nu d/dy) f_new = f,
by batched Thomas solves (`ops.tridiag.thomas`), with the wall rows
folded in as the explicit ghost rules fold them. It removes the y
diffusion limit of the explicit step on stretched near-wall cells (the
IMEX companion of `Config.implicit_y_diffusion`). Trip forcing and the
velocity filter of the same module are ROADMAP A.14.
"""

from __future__ import annotations

import torch

from .config import BCType
from .ops.operators import c2f_mean
from .ops.tridiag import thomas


def _is_scalar(nu) -> bool:
    return not torch.is_tensor(nu) or nu.ndim == 0


def _y_wall(geom) -> bool:
    yax = geom.axes[1]
    return not yax.periodic and yax.n > 2 and yax.bc == BCType.WALL


def implicit_scalar_y_diffusion(f, nu_eff, dt, geom, wall_value=0.0):
    """(I - dt d/dy nu d/dy) f_new = f + dt * wall source, for a
    cell-centred scalar with the Dirichlet value `wall_value` at both y
    walls (k = 0, omega = omega_wall: the transport's IMEX companion of the
    momentum solve). Only on a WALL y: an open y keeps its explicit
    zero-gradient ghosts, so there f is returned as it is."""
    if not _y_wall(geom):
        return f
    yax = geom.axes[1]
    inv_d, inv_dc = yax.inv_d, yax.inv_dc
    if _is_scalar(nu_eff):
        nu_f_lo = nu_f_hi = nu_eff
    else:
        nu_face = torch.cat(
            [nu_eff[:, :1, :], 0.5 * (nu_eff[:, :-1, :] + nu_eff[:, 1:, :]),
             nu_eff[:, -1:, :]], dim=1)
        nu_f_lo = nu_face[:, :-1, :]
        nu_f_hi = nu_face[:, 1:, :]
    g_lo = nu_f_lo * inv_dc[:, :-1, :] * inv_d
    g_hi = nu_f_hi * inv_dc[:, 1:, :] * inv_d
    lower = -dt * g_lo
    upper = -dt * g_hi
    diag = 1.0 + dt * (g_lo + g_hi)
    # the inhomogeneous Dirichlet wall flux (f0 - wall_value) / dc0 adds the
    # known source dt * g * wall_value at the wall rows (thomas ignores
    # lower[0] and upper[-1], so the unknowns' coupling is already right)
    # (the wall rows' indicators formed on the device: no host copy, which
    # a CUDA graph capture refuses)
    ny = f.shape[1]
    j = torch.arange(ny, device=f.device).reshape(1, -1, 1)
    first = (j == 0).to(f.dtype)
    last = (j == ny - 1).to(f.dtype)
    rhs = f + dt * (g_lo * first + g_hi * last) * wall_value
    return thomas(lower, diag, upper, rhs, axis=1)


def implicit_y_diffusion(comps, nu_eff, dt, geom):
    """Solve (I - dt d/dy nu d/dy) u_new = u for each component by batched
    Thomas solves. The walls enter as the explicit ghost rules: u and w
    (cell-centred in y) see the no-slip ghost -interior, which is the
    zero-Dirichlet scalar solve; v keeps its boundary faces and solves the
    interior faces. A cell nu is averaged onto u's and w's own face grid
    along their axis (`c2f_mean`, with the wrap on a periodic axis), as
    the explicit operator places it. On a non-wall y nothing is done."""
    if not _y_wall(geom):
        return comps
    scalar_nu = _is_scalar(nu_eff)
    yax = geom.axes[1]
    inv_d, inv_dc = yax.inv_d, yax.inv_dc
    out = []
    for s in range(3):
        f = comps[s]
        if s == 1:
            # v: the boundary faces are Dirichlet (0); face j of the
            # interior couples v[j - 1], v[j], v[j + 1] through the cells
            # j - 1 and j
            nu_lo = nu_eff if scalar_nu else nu_eff[:, :-1, :]
            nu_hi = nu_eff if scalar_nu else nu_eff[:, 1:, :]
            a_lo = nu_lo * inv_d[:, :-1, :] * inv_dc[:, 1:-1, :]
            a_hi = nu_hi * inv_d[:, 1:, :] * inv_dc[:, 1:-1, :]
            sol = thomas(-dt * a_lo, 1.0 + dt * (a_lo + a_hi), -dt * a_hi,
                         f[:, 1:-1, :], axis=1)
            f = torch.cat([f[:, :1, :], sol, f[:, -1:, :]], dim=1)
        else:
            nu_s = (nu_eff if scalar_nu
                    else c2f_mean(nu_eff, s, geom.axes[s], kind="scalar"))
            f = implicit_scalar_y_diffusion(f, nu_s, dt, geom, 0.0)
        out.append(f)
    return tuple(out)
