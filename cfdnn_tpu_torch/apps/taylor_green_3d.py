"""3-D Taylor-Green vortex app (port of `cfdnn_tpu/apps/taylor_green_3d.py`):
all-periodic box, skew convection, RK3 with adaptive dt; kinetic-energy
decay and enstrophy.

    python -m cfdnn_tpu_torch.apps.taylor_green_3d --Nx 128 --Ny 128 --Nz 128 --Re 1600
"""

from __future__ import annotations

import numpy as np

from ..config import (BCType, Config, ConvectiveScheme, SimulationMode,
                      TimeIntegrator)
from ..fields import init_taylor_green
from .runner import run_case


def default_config() -> Config:
    return Config(
        Nx=64, Ny=64, Nz=64,
        x_min=0.0, x_max=2 * np.pi, y_min=0.0, y_max=2 * np.pi,
        z_min=0.0, z_max=2 * np.pi,
        bc_x=BCType.PERIODIC, bc_y=BCType.PERIODIC, bc_z=BCType.PERIODIC,
        nu=1.0 / 1600.0, nu_specified=True, dp_dx=0.0, dp_dx_specified=True,
        dt=1e-3, adaptive_dt=True, CFL_max=0.5,
        time_integrator=TimeIntegrator.RK3,
        convective_scheme=ConvectiveScheme.SKEW,
        simulation_mode=SimulationMode.UNSTEADY,
        max_steps=2000, output_freq=100, dtype="float32",
    )


def enstrophy(sim, state) -> float:
    """Volume-averaged enstrophy 0.5 <|omega|^2> from the cell-centred
    gradient tensor."""
    from ..turbulence.base import strain_rotation
    sr = strain_rotation((state.u, state.v, state.w), sim.geom)
    w2 = 4.0 * (sr.O12**2 + sr.O13**2 + sr.O23**2)
    return 0.5 * float(w2.mean())


def validate(sim, state, diags):
    ke = float(diags.ke)
    ens = enstrophy(sim, state)
    print(f"[tgv3d] t={float(state.t):.3f} KE={ke:.6f} enstrophy={ens:.4f}")
    return {"tgv_ke": ke, "tgv_enstrophy": ens,
            "div_linf": float(diags.div_linf)}


def main(argv=None):
    return run_case("taylor_green_3d", default_config(), argv,
                    ic=init_taylor_green, validate=validate)


if __name__ == "__main__":
    main()
