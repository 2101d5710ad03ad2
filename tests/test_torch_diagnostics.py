"""The port's diagnostics (cfdnn_tpu_torch/diagnostics.py) against the JAX
reference's (cfdnn_tpu/diagnostics.py) at float64 on the CPU, each given
the same arrays: a 16^3 Taylor-Green box and a perturbed, stretched
16x24x16 channel (laminar, and with the Smagorinsky closure for the
energy budget and the momentum closure). Floats and arrays to 1e-12
relative (of each array's scale); flags, counts and classifier states
exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu.diagnostics as RD
import cfdnn_tpu_torch as T
import cfdnn_tpu_torch.diagnostics as TD

KEYS = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "k", "omega",
        "nu_t")
TGV = dict(Nx=16, Ny=16, Nz=16, y_min=0.0, y_max=2 * np.pi,
           z_max=2 * np.pi, nu=1e-3, nu_specified=True, dp_dx=0.0,
           dp_dx_specified=True, dtype="float64")
# nu small enough that the laminar wall shear gives Re_tau ~ 316, so the
# log-law window y+ in [30, 110] holds cells
CHANNEL = dict(Nx=16, Ny=24, Nz=16, stretch_y=True, nu=1e-4,
               nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
               dtype="float64")


def _pair(turb=None, **kw):
    rk, tk = dict(kw), dict(kw)
    for name in ("bc_x", "bc_y", "bc_z"):
        if name in kw:
            rk[name], tk[name] = R.BCType(kw[name]), T.BCType(kw[name])
    if turb:
        rk["turb_model"] = R.TurbulenceModel(turb)
        tk["turb_model"] = T.TurbulenceModel(turb)
    return R.Simulation(R.Config(**rk)), T.Simulation(T.Config(**tk),
                                                      device="cpu")


def _to_port(state):
    return T.state_from_numpy(
        {k: np.asarray(getattr(state, k)) for k in KEYS
         if getattr(state, k, None) is not None}, "cpu", torch.float64)


def _close(got, want, what, tol=1e-12):
    want = np.asarray(want, dtype=float)
    got = np.asarray(got, dtype=float)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _close_dict(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (bool, np.bool_)) or isinstance(w, int):
            assert g == w, k
        else:
            _close(g, w, k)


def _close_stats(got, want):
    for f in dataclasses.fields(RD.ChannelStats):
        _close(getattr(got, f.name), getattr(want, f.name), f.name)


def _tgv():
    rs, ps = _pair(bc_x="periodic", bc_y="periodic", bc_z="periodic", **TGV)
    r = R.init_taylor_green(rs.cfg, rs.mesh)
    return rs, ps, r, _to_port(r)


def _channel(turb=None, seed=0):
    import jax
    rs, ps = _pair(turb, **CHANNEL)
    r = R.perturbed_channel(rs.cfg, rs.mesh, jax.random.PRNGKey(seed),
                            amp=0.2)
    if turb:
        r = r.replace(nu_t=rs.turb.nu_t(r, rs))
    return rs, ps, r, _to_port(r)


@pytest.mark.parametrize("grid", ["tgv", "channel"])
def test_energy_and_spectra_match_reference(grid):
    """volume_mean (of p^2: p's own mean cancels), kinetic_energy,
    dissipation_rate (scalar nu), energy_budget (laminar),
    spanwise_spectrum and its pile-up ratio; on the box also
    energy_spectrum_3d (Parseval: its sum is the mean KE)."""
    rs, ps, r, p = _tgv() if grid == "tgv" else _channel()
    rc, pc = (r.u, r.v, r.w), p.velocity
    _close(float(TD.volume_mean(p.p ** 2, ps.geom)),
           float(RD.volume_mean(r.p ** 2, rs.geom)), "volume_mean")
    _close(float(TD.kinetic_energy(pc, ps.geom)),
           float(RD.kinetic_energy(rc, rs.geom)), "kinetic_energy")
    _close(float(TD.dissipation_rate(pc, 1e-3, ps.geom)),
           float(RD.dissipation_rate(rc, 1e-3, rs.geom)), "dissipation")
    _close_dict(TD.energy_budget(ps, p), RD.energy_budget(rs, r))
    E_p, E_r = TD.spanwise_spectrum(ps, p), RD.spanwise_spectrum(rs, r)
    _close(E_p, E_r, "spanwise_spectrum")
    # a ratio of spectrum values: 1e-12 absolute (the box's Nyquist tail is
    # roundoff, ~1e-32 of its peak)
    assert abs(TD.spectrum_pileup_ratio(E_p)
               - RD.spectrum_pileup_ratio(E_r)) <= 1e-12
    if grid == "tgv":
        kp, Ep = TD.energy_spectrum_3d(ps, p)
        kr, Er = RD.energy_spectrum_3d(rs, r)
        np.testing.assert_array_equal(kp, kr)
        _close(Ep, Er, "energy_spectrum_3d")
        _close(Ep.sum(), float(TD.kinetic_energy(pc, ps.geom)), "Parseval",
               tol=1e-10)
    else:
        with pytest.raises(ValueError, match="all-periodic"):
            TD.energy_spectrum_3d(ps, p)


def test_energy_budget_with_a_closure_matches_reference():
    """energy_budget and momentum_balance_closure with Smagorinsky on:
    nu_eff = nu + the closure's nu_t of the state."""
    rs, ps, r, p = _channel("smagorinsky")
    assert p.nu_t is not None and float(p.nu_t.max()) > 0
    _close_dict(TD.energy_budget(ps, p), RD.energy_budget(rs, r))
    _close(TD.momentum_balance_closure(ps, p),
           RD.momentum_balance_closure(rs, r), "closure")


def test_channel_statistics_and_reports_match_reference():
    """channel_statistics, momentum_balance_closure, realism_report (the
    Stage-F gates, _stage_f_gates) and log_law_fit of the snapshot."""
    rs, ps, r, p = _channel()
    st_p, st_r = TD.channel_statistics(ps, p), RD.channel_statistics(rs, r)
    _close_stats(st_p, st_r)
    _close(TD.momentum_balance_closure(ps, p),
           RD.momentum_balance_closure(rs, r), "closure")
    _close_dict(TD.realism_report(ps, p), RD.realism_report(rs, r))
    fit_p, fit_r = TD.log_law_fit(st_p), RD.log_law_fit(st_r)
    assert fit_p["n_fit_points"] == fit_r["n_fit_points"] >= 3
    _close_dict(fit_p, fit_r)


def test_log_law_fit_of_a_log_profile():
    """log_law_fit on a synthetic ChannelStats whose U+ is exactly
    (1/0.41) ln y+ + 5.2 in the log layer: kappa and B recovered, and the
    reference's fit of the same stats."""
    Re_tau, n = 590.0, 96
    y = -1.0 + (np.arange(n) + 0.5) * 2.0 / n
    yp = (1.0 - np.abs(y)) * Re_tau
    U = np.log(yp) / 0.41 + 5.2
    z = np.zeros(n)
    st = dict(y=y, U=U, u_rms=z, v_rms=z, w_rms=z, uv=z, u_tau=1.0,
              Re_tau=Re_tau, y_plus_1=yp[0], dx_plus=0.0, dz_plus=0.0)
    fit = TD.log_law_fit(TD.ChannelStats(**st))
    assert abs(fit["kappa"] - 0.41) < 1e-9 and abs(fit["B"] - 5.2) < 1e-9
    _close_dict(fit, RD.log_law_fit(RD.ChannelStats(**st)))
    assert TD.MKM_CENTERLINE_U_PLUS == RD.MKM_CENTERLINE_U_PLUS
    assert TD.MKM_BULK_U_PLUS == RD.MKM_BULK_U_PLUS


def test_stats_accumulator_matches_reference():
    """StatsAccumulator over three states: the time-averaged
    ChannelStats, its closure defect and realism_report_averaged."""
    acc_r, acc_p = None, None
    for seed in range(3):
        rs, ps, r, p = _channel(seed=seed)
        if acc_r is None:
            acc_r, acc_p = RD.StatsAccumulator(rs), TD.StatsAccumulator(ps)
        acc_r.update(r)
        acc_p.update(p)
    assert acc_p.n == acc_r.n == 3
    _close_stats(acc_p.finalize(), acc_r.finalize())
    _close(acc_p.momentum_balance_closure(), acc_r.momentum_balance_closure(),
           "closure")
    _close_dict(TD.realism_report_averaged(ps, p, acc_p),
                RD.realism_report_averaged(rs, r, acc_r))
    with pytest.raises(ValueError, match="no snapshots"):
        TD.StatsAccumulator(ps).finalize()


def test_presence_classifier_hysteresis_matches_reference():
    """TurbulencePresenceClassifier over a sequence of transverse
    fluctuation levels, up through `hi`, down through `lo` and back: the
    reference's state after every update, which must enter 'turbulent' and
    leave it again."""
    rs, ps, r, p = _channel()
    levels = [0.0] * 3 + [1e-2] * 6 + [5e-4] * 4 + [1e-5] * 6 + [1e-2] * 2
    rng = np.random.default_rng(7)
    cr = RD.TurbulencePresenceClassifier(window=4)
    cp = TD.TurbulencePresenceClassifier(window=4)
    states = []
    for a in levels:
        v = a * rng.standard_normal(np.asarray(r.v).shape)
        w = a * rng.standard_normal(np.asarray(r.w).shape)
        sr = cr.update(rs, r.replace(v=v, w=w))
        sp = cp.update(ps, p.replace(v=torch.as_tensor(v),
                                     w=torch.as_tensor(w)))
        assert sp == sr
        states.append(sp)
    _close(cp.history, cr.history, "history")
    assert "turbulent" in states and states[-1] == "laminar"
    assert states.index("turbulent") < len(states) - 1
