"""Channel-flow app (port of `cfdnn_tpu/apps/channel.py`): periodic x (and
z), no-slip y walls, pressure-gradient driven; the laminar steady case is
held to the analytic Poiseuille profile (the reference C++ code's relL2
3.34e-4 baseline).

    python -m cfdnn_tpu_torch.apps.channel --Nx 64 --Ny 64 --model sst ...
"""

from __future__ import annotations

import numpy as np

from ..config import BCType, Config, SimulationMode, TurbulenceModel
from ..fields import init_poiseuille, poiseuille_exact
from .runner import run_case


def default_config() -> Config:
    return Config(
        Nx=64, Ny=64, Nz=1,
        bc_x=BCType.PERIODIC, bc_y=BCType.WALL, bc_z=BCType.PERIODIC,
        nu=1e-3, nu_specified=True, dp_dx=-2e-3, dp_dx_specified=True,
        dt=1e-3, simulation_mode=SimulationMode.STEADY,
        tol=1e-8, max_steps=50000, output_freq=1000, dtype="float64",
    )


def validate(sim, state, diags):
    cfg = sim.cfg
    if cfg.turb_model != TurbulenceModel.NONE:
        return {"final_residual": float(diags.residual)}
    from ..ops.operators import f2c_mean
    u_c = f2c_mean(state.u, 0, sim.geom.axes[0]).detach().cpu().numpy()
    prof = u_c.mean(axis=(0, 2))
    exact = poiseuille_exact(cfg, sim.mesh.y.centers)
    rel_l2 = np.linalg.norm(prof - exact) / np.linalg.norm(exact)
    print(f"[channel] Poiseuille relL2 = {rel_l2:.4e} "
          f"(reference baseline 3.34e-4)")
    return {"poiseuille_rel_l2": rel_l2,
            "div_linf": float(diags.div_linf)}


def main(argv=None):
    return run_case(
        "channel", default_config(), argv,
        ic=lambda cfg, mesh, device: init_poiseuille(cfg, mesh, 0.0,
                                                     device=device),
        validate=validate)


if __name__ == "__main__":
    main()
