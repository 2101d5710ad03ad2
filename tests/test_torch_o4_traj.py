"""5-step trajectories of the port's O4 paths (space_order=4) against the
JAX package's, with use_pallas="on" in both (the port through its
wrappers' twins, the reference through its interpret-mode kernels), at
float64 on the CPU: the O4 Re 1600 Taylor-Green (RK3, adaptive dt), the
central channel, the Smagorinsky channel, a dynamic-Smagorinsky box and a
k-omega channel. (tests/test_torch_o4.py holds the rest of O4.)
"""

import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from test_torch_o4 import PATHS, _ref_cfg




KEYS = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "nu_t", "k",
        "omega")


def _initial(name, rs):
    if name in ("tgv_re1600_o4", "dynamic_box_o4"):
        return R.init_taylor_green(rs.cfg, rs.mesh)
    return rs.initialize(R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05))


@pytest.mark.parametrize("name", ["tgv_re1600_o4", "channel_o4",
                                  "les_channel_o4", "dynamic_box_o4",
                                  "komega_channel_o4"])
def test_trajectory_matches_reference(name):
    """5 steps with use_pallas="on" in both packages (the port through its
    wrappers' twins, the reference through its interpret-mode kernels)
    from the reference's initial state: u, v, w, nu_t, k and omega to
    1e-12 of each one's scale, p to 1e-12 of the larger of its own and
    the velocity's (it solves div(u*) / dt: its roundoff is the
    velocity's over dt), and each step's dt to 1e-14."""
    tcfg, plan = PATHS[name]
    tcfg = tcfg.with_(use_pallas="on")
    rs = R.Simulation(_ref_cfg(tcfg))
    ts = T.Simulation(tcfg, device="cpu")
    assert ts.kernels == plan
    r = _initial(name, rs)
    t = T.state_from_numpy({k: np.asarray(getattr(r, k)) for k in KEYS
                            if getattr(r, k, None) is not None}, "cpu",
                           torch.float64)
    for _ in range(5):
        r, rd = rs.step(r)
        t, td = ts.step(t)
        np.testing.assert_allclose(float(td.dt), float(rd.dt), rtol=1e-14)
    out = T.state_to_numpy(t)
    scales = {k: float(np.max(np.abs(np.asarray(getattr(r, k)))))
              for k in ("u", "v", "w", "p", "nu_t", "k", "omega")
              if getattr(r, k, None) is not None}
    vel = max(scales["u"], scales["v"], scales["w"])
    for k, scale in scales.items():
        lim = 1e-12 * (max(scale, vel) if k == "p" else scale)
        np.testing.assert_allclose(out[k], np.asarray(getattr(r, k)),
                                   rtol=0, atol=lim, err_msg=k)
    assert float(td.div_linf) < 1e-10
    if tcfg.adaptive_dt:
        assert float(td.dt) != float(tcfg.dt)
