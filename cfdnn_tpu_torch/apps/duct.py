"""Square-duct app (port of `cfdnn_tpu/apps/duct.py`): periodic x, no-slip
walls in both y and z; the laminar bulk velocity is held to the exact
series solution.

    python -m cfdnn_tpu_torch.apps.duct --Nx 64 --Ny 48 --Nz 48
"""

from __future__ import annotations

import numpy as np

from ..config import BCType, Config, SimulationMode
from .runner import run_case


def default_config() -> Config:
    return Config(
        Nx=64, Ny=48, Nz=48,
        x_min=0.0, x_max=4.0, y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0,
        bc_x=BCType.PERIODIC, bc_y=BCType.WALL, bc_z=BCType.WALL,
        nu=1e-3, nu_specified=True, dp_dx=-2e-3, dp_dx_specified=True,
        dt=1e-3, simulation_mode=SimulationMode.STEADY,
        tol=1e-7, max_steps=20000, output_freq=500, dtype="float64",
    )


def validate(sim, state, diags):
    """Laminar duct: the volume-weighted bulk velocity against the exact
    series solution of the square cross-section."""
    cfg = sim.cfg
    from ..ops.operators import f2c_mean
    u_c = f2c_mean(state.u, 0, sim.geom.axes[0]).detach().cpu().numpy()
    # volume-weighted: a plain mean over-weights the fine near-wall cells
    # of --stretch_y/--stretch_z
    wy = np.asarray(sim.mesh.y.d).reshape(1, -1, 1)
    wz = np.asarray(sim.mesh.z.d).reshape(1, 1, -1)
    u_bulk = float((u_c * wy * wz).sum()
                   / (u_c.shape[0] * wy.sum() * wz.sum()))
    if abs(cfg.Ly - cfg.Lz) > 1e-12 * cfg.Ly:
        # the series below is the square cross-section's (a = b)
        print(f"[duct] rectangular cross-section Ly={cfg.Ly:g} != "
              f"Lz={cfg.Lz:g}: series gate skipped (square-only)")
        return {"duct_u_bulk": u_bulk, "div_linf": float(diags.div_linf)}
    a = 0.5 * cfg.Ly
    G = -cfg.dp_dx / cfg.rho
    s = 0.0
    for n in range(1, 40, 2):
        s += np.tanh(n * np.pi / 2.0) / n**5
    Q_exact = (G * a**4 / (3.0 * cfg.nu)) * (1.0 - 192.0 / np.pi**5 * s) * 4.0
    u_bulk_exact = Q_exact / (cfg.Ly * cfg.Lz)
    rel = abs(u_bulk - u_bulk_exact) / abs(u_bulk_exact)
    print(f"[duct] u_bulk={u_bulk:.6f} exact={u_bulk_exact:.6f} rel={rel:.3e}")
    return {"duct_bulk_rel_err": rel, "div_linf": float(diags.div_linf)}


def main(argv=None):
    return run_case("duct", default_config(), argv, validate=validate)


if __name__ == "__main__":
    main()
