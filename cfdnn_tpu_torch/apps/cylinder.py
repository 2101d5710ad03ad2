"""IBM cylinder-in-crossflow app (port of `cfdnn_tpu/apps/cylinder.py`):
by default a periodic channel with an immersed cylinder; with
`--external` a unit cylinder in a 20 x 16 box with the inflow/outflow pair
(the pinned inlet and the outlet's flux anchor). Cd/Cl time series, and
the Strouhal number from the lift's zero crossings.

    python -m cfdnn_tpu_torch.apps.cylinder --Nx 256 --Ny 128
    python -m cfdnn_tpu_torch.apps.cylinder --external
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import BCType, Config, SimulationMode, TimeIntegrator
from ..fields import zero_state
from ..ibm import CylinderBody
from .runner import run_case

D = 0.1          # cylinder diameter
CX, CY = 0.5, 0.5


def default_config() -> Config:
    return Config(
        Nx=128, Ny=64, Nz=1,
        x_min=0.0, x_max=2.0, y_min=0.0, y_max=1.0,
        bc_x=BCType.PERIODIC, bc_y=BCType.WALL,
        nu=1e-3, nu_specified=True, dp_dx=-5e-3, dp_dx_specified=True,
        dt=5e-4, adaptive_dt=True,
        time_integrator=TimeIntegrator.RK2,
        simulation_mode=SimulationMode.UNSTEADY,
        max_steps=5000, output_freq=200, dtype="float32",
    )


def make_body(cfg, mesh):
    return CylinderBody(CX, CY, 0.5 * D)


def make_body_external(cfg, mesh):
    return CylinderBody(5.0, 0.0, 0.5)   # unit diameter at (5, 0)


def external_ic(cfg, mesh, *, device):
    """A uniform freestream and a small asymmetric seed; the inlet face of
    this state becomes the pinned inflow profile at `initialize`."""
    st = zero_state(cfg, device=device)
    dtype = st.u.dtype
    yc = torch.as_tensor(mesh.y.centers, dtype=torch.float64,
                         device=device)[None, :, None]
    xc = torch.as_tensor(mesh.x.centers, dtype=torch.float64,
                         device=device)[:, None, None]
    v0 = 1e-2 * torch.exp(-(yc ** 2)) * torch.sin(xc)
    return st.replace(u=torch.full_like(st.u, 1.0),
                      v=torch.broadcast_to(v0, st.v.shape).to(dtype)
                      .contiguous())


class ForceRecorder:
    """Cd/Cl time series and the Strouhal number from Cl's zero crossings.

    `u_ref`: the fixed reference velocity of the coefficients; the
    external case's must be the freestream U_inf = 1 (the domain mean
    holds the wake's deficit). None takes the instantaneous domain mean,
    for the channel-confined default case.
    """

    def __init__(self, sim, diameter: float = D, u_ref=None):
        self.sim = sim
        self.D = diameter
        self.u_ref = u_ref
        self.t, self.cd, self.cl = [], [], []

    def __call__(self, it, state, d):
        u_ref = self.u_ref
        if u_ref is None:
            u_ref = max(abs(float(state.u.mean())), 1e-9)
        denom = 0.5 * u_ref**2 * self.D
        self.t.append(float(state.t))
        self.cd.append(float(d.fx) / denom)
        self.cl.append(float(d.fy) / denom)

    def strouhal(self):
        if len(self.t) < 16:
            return 0.0
        # the developed-shedding tail (the last half): crossings from step
        # 1 would average the transient's wiggles into the period
        n0 = len(self.t) // 2
        cl = np.asarray(self.cl[n0:])
        t = np.asarray(self.t[n0:])
        cl = cl - cl.mean()
        sgn = np.sign(cl)
        # carry the previous sign through exact zeros, so that a sample on
        # 0 does not count one crossing twice
        for i in range(1, len(sgn)):
            if sgn[i] == 0:
                sgn[i] = sgn[i - 1]
        crossings = np.where(np.diff(sgn) > 0)[0]
        if len(crossings) < 2:
            return 0.0
        period = (t[crossings[-1]] - t[crossings[0]]) / (len(crossings) - 1)
        u_ref = self.u_ref if self.u_ref is not None else 1.0
        return self.D / (period * u_ref) if period > 0 else 0.0


def external_config() -> Config:
    """The external-flow variant (--external): a unit-diameter cylinder in
    a 20 x 16 box with the inflow/outflow pair (the pinned inlet and the
    outlet's flux anchor), the configuration of
    validation/run_cylinder_strouhal.py at Re 100."""
    return Config(
        Nx=384, Ny=256, Nz=1,
        x_min=0.0, x_max=20.0, y_min=-8.0, y_max=8.0,
        bc_x=BCType.INFLOW, bc_y=BCType.PERIODIC,
        nu=1e-2, nu_specified=True, dp_dx=0.0, dp_dx_specified=True,
        dt=5e-3, adaptive_dt=False,
        simulation_mode=SimulationMode.UNSTEADY,
        max_steps=24000, output_freq=500, dtype="float32",
    )


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    external = "--external" in argv
    argv = [a for a in argv if a != "--external"]
    cfg = external_config() if external else default_config()
    rec = ForceRecorder(None, diameter=1.0 if external else D,
                        u_ref=1.0 if external else None)
    case = "cylinder_external" if external else "cylinder"

    def validate(sim, state, diags):
        out = {"final_ke": float(diags.ke)}
        if rec.cd:
            out["cd_mean_tail"] = float(np.mean(rec.cd[-len(rec.cd) // 4:]))
            out["strouhal"] = rec.strouhal()
            print(f"[{case}] Cd(tail)={out['cd_mean_tail']:.3f} "
                  f"St={out['strouhal']:.3f}")
        return out

    return run_case(case, cfg, argv,
                    body=make_body_external if external else make_body,
                    ic=external_ic if external else None,
                    callback=rec, validate=validate)


if __name__ == "__main__":
    main()
