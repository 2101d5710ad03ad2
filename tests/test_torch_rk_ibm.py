"""The port's RK2/RK3 integrators, adaptive dt and immersed boundary
(solver.py, ibm/geometry.py, ibm/forcing.py) and the two bench rows they
bring (tgv_re1600, les_ibm256), against the JAX reference at float64 on the
CPU.

Initial states are the reference's, handed across as NumPy arrays; the
port runs its kernels' twins (use_pallas="on") or its operator chain
("off"), the reference its operator chain ("off"; its interpret-mode
kernels are held to the port's twins in the kernel tests). Limits: 5-step
trajectories 1e-12 of each field's scale in u, v, w, p (k, omega, nu_t of
the RANS run) and the IBM force sums, dt to 1e-12 relative; the SDFs, IBM
weights, masks and counts exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu import ibm as RI
from cfdnn_tpu_torch import bench, ibm as TI
from cfdnn_tpu_torch.solver import KernelPlan

PHYS = dict(nu=1e-3, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
            dt=1e-3, adaptive_dt=False, dtype="float64")
TGV = dict(Nx=16, Ny=16, Nz=16, bc_x="periodic", bc_y="periodic",
           bc_z="periodic", y_min=0.0, y_max=2 * np.pi, z_max=2 * np.pi,
           dp_dx=0.0, convective_scheme="skew")
CHANNEL = dict(Nx=16, Ny=24, Nz=8, stretch_y=True, z_max=1.0)
# (grid, integrator, closure, start) of the RK / adaptive-dt trajectories;
# the channels at nu 1e-4, where the CFL limit, not the diffusion limit,
# sets dt
RK_CASES = {
    "tgv-rk3": (TGV, "rk3", None, "tgv"),
    "channel-rk2": (dict(CHANNEL, nu=1e-4), "rk2", None, "channel"),
    "les_channel-rk3": (dict(CHANNEL, Ny=12, nu=1e-4), "rk3", "smagorinsky",
                        "channel"),
    "sst_channel-rk3": (dict(CHANNEL, nu=1e-4), "rk3", "sst", "rans"),
}
KEYS = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "k", "omega",
        "nu_t")
# a channel around a cylinder of radius 0.25 on the centre line, at 2.5
# cells a radius in x
IBM_CHANNEL = dict(Nx=24, Ny=16, Nz=8, x_max=3.0, z_max=1.0, stretch_y=True,
                   nu=1e-2, dp_dx=-0.5)


def _cfg(pkg, **kw):
    k = dict(PHYS, **kw)
    for name, enum_ in (("bc_x", pkg.BCType), ("bc_y", pkg.BCType),
                        ("bc_z", pkg.BCType),
                        ("convective_scheme", pkg.ConvectiveScheme),
                        ("turb_model", pkg.TurbulenceModel),
                        ("time_integrator", pkg.TimeIntegrator)):
        if name in k:
            k[name] = enum_(k[name])
    return pkg.Config(**k)


def _to_port(state):
    return T.state_from_numpy(
        {k: np.asarray(getattr(state, k)) for k in KEYS
         if getattr(state, k) is not None}, "cpu", torch.float64)


def _close_scaled(got, want, what, tol=1e-12):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _start(rs, start):
    if start == "tgv":
        return R.init_taylor_green(rs.cfg, rs.mesh)
    r = R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05)
    return rs.initialize(r) if start == "rans" else r


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("case", sorted(RK_CASES))
def test_rk_adaptive_trajectory_matches_reference(case, mode):
    """5 steps of RK2/RK3 with adaptive dt (CFL 0.5, no benchmark mode):
    u, v, w, p (and k, omega, nu_t) to 1e-12 of scale, each step's dt to
    1e-12 relative, and dt a 0-d tensor that changes from step to step."""
    grid, ti, closure, start = RK_CASES[case]
    kw = dict(grid, time_integrator=ti, adaptive_dt=True, CFL_max=0.5)
    if closure:
        kw["turb_model"] = closure
    rs = R.Simulation(_cfg(R, **kw, use_pallas="off"))
    ts = T.Simulation(_cfg(T, **kw, use_pallas=mode), device="cpu")
    assert ts.cfg.adaptive_dt and ts.kernels.predictor == (
        None if mode == "off" else ("periodic" if start == "tgv"
                                    else "channel"))
    r = _start(rs, start)
    t = _to_port(r)
    dts = []
    for _ in range(5):
        r, rd = rs.step(r)
        t, td = ts.step(t)
        assert td.dt.ndim == 0 and td.dt.dtype == torch.float64
        np.testing.assert_allclose(float(td.dt), float(rd.dt), rtol=1e-12,
                                   atol=0)
        dts.append(float(td.dt))
    assert len(set(dts)) > 1, dts
    out = T.state_to_numpy(t)
    for key in ("u", "v", "w", "p", "k", "omega", "nu_t"):
        if getattr(r, key) is not None:
            _close_scaled(out[key], getattr(r, key), key)
    assert float(td.div_linf) < 1e-10


@pytest.mark.parametrize("kind,kw", [
    ("cylinder", dict(cx=1.0, cy=0.1, radius=0.3)),
    ("sphere", dict(cx=1.0, cy=0.1, cz=0.4, radius=0.3)),
    ("naca", dict(x_le=0.5, y_le=0.05, chord=1.2, aoa=0.1, digits="2412")),
    ("airfoil", dict(x_le=0.5, y_le=0.0, chord=1.0)),
    ("step", dict(x_step=1.1, y_step=-0.2)),
    ("bfs", dict(x_step=0.9, y_step=0.1)),
    ("hills", dict(h=0.2)),
])
def test_sdf_bodies_match_reference(kind, kw):
    """Every body kind of create_ibm_body: phi, the outward normal and the
    closest point on a 3-D grid equal the reference's exactly."""
    xs = np.linspace(-0.5, 2.5, 31)
    ys = np.linspace(-1.0, 1.0, 21)
    zs = np.linspace(0.0, 1.0, 5)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    rb, tb = RI.create_ibm_body(kind, **kw), TI.create_ibm_body(kind, **kw)
    assert type(tb).__name__ == type(rb).__name__ and tb.name == rb.name
    np.testing.assert_array_equal(tb.phi(X, Y, Z), rb.phi(X, Y, Z))
    for a, b in zip(tb.normal(X, Y, Z), rb.normal(X, Y, Z)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tb.closest_point(X, Y, Z), rb.closest_point(X, Y, Z)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown IBM body"):
        TI.create_ibm_body("blob")


@pytest.mark.parametrize("grid", ["stretched-3d", "2d"])
def test_ibm_forcing_matches_reference(grid):
    """IBMForcing of a cylinder: the face weights, fluid_cell,
    fluid_interior, n_solid, n_forcing and band equal the reference
    object's; apply and mask_rhs on random fields, and the force sums, to
    1e-12 of scale."""
    kw = (dict(IBM_CHANNEL) if grid == "stretched-3d"
          else dict(IBM_CHANNEL, Nz=1))
    rs = R.Simulation(_cfg(R, **kw))
    ts = T.Simulation(_cfg(T, **kw), device="cpu")
    body = dict(cx=1.0, cy=0.05, radius=0.3)
    rf = RI.IBMForcing(rs.mesh, RI.CylinderBody(**body), rs.cfg)
    tf = TI.IBMForcing(ts.mesh, TI.CylinderBody(**body), ts.cfg,
                       device="cpu")
    for name in ("w_u", "w_v", "w_w", "fluid_cell", "fluid_interior"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(rf, name)), name)
    for name in ("n_solid", "n_forcing", "band"):
        assert getattr(tf, name) == getattr(rf, name), name
    assert tf.n_solid > 0 and tf.n_forcing > 0
    rng = np.random.default_rng(11)
    comps = [rng.standard_normal(s) for s in T.velocity_shapes(ts.cfg)]
    dt = 3e-3
    (ru, rv, rw), rforce = rf.apply(tuple(comps), dt, accumulate=True)
    (tu, tv, tw), tforce = tf.apply(
        tuple(torch.from_numpy(c) for c in comps),
        torch.tensor(dt, dtype=torch.float64), accumulate=True)
    for a, b in ((tu, ru), (tv, rv), (tw, rw)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tforce, rforce):
        assert a.ndim == 0
        _close_scaled(float(a), float(b), "force")
    assert tf.apply(tuple(torch.from_numpy(c) for c in comps))[1] is None
    rhs = rng.standard_normal((kw["Nx"], kw["Ny"], kw.get("Nz", 8)))
    np.testing.assert_array_equal(tf.mask_rhs(torch.from_numpy(rhs)).numpy(),
                                  np.asarray(rf.mask_rhs(rhs)))
    cd, cl = tf.drag_lift_coefficients(tforce, 1.0, 0.6)
    rcd, rcl = rf.drag_lift_coefficients(rforce, 1.0, 0.6)
    _close_scaled(float(cd), float(rcd), "Cd")
    _close_scaled(float(cl), float(rcl), "Cl")


IBM_RUNS = {
    "euler": dict(IBM_CHANNEL),
    "rk3": dict(IBM_CHANNEL, time_integrator="rk3"),
    "rk2-adaptive": dict(IBM_CHANNEL, time_integrator="rk2",
                         adaptive_dt=True),
    "les_ibm": None,   # bench.les_ibm_config at 32x16x32
}


@pytest.mark.parametrize("case", sorted(IBM_RUNS))
def test_ibm_trajectory_matches_reference(case):
    """5 steps with a cylinder attached: the port under use_pallas="on"
    against the reference ("off"), u, v, w, p and each step's fx, fy, fz
    and the fluid-region divergence."""
    if IBM_RUNS[case] is None:
        tcfg = bench.les_ibm_config(32, "float64", benchmark=False,
                                    use_pallas="on")
        fields = {f.name: getattr(tcfg, f.name)
                  for f in dataclasses.fields(tcfg)}
        fields["turb_model"] = R.TurbulenceModel(tcfg.turb_model.value)
        fields["use_pallas"] = "off"
        rcfg = R.Config(**fields)
        body = dict(cx=1.0, cy=0.0, radius=0.25)
    else:
        rcfg = _cfg(R, **IBM_RUNS[case], use_pallas="off")
        tcfg = _cfg(T, **IBM_RUNS[case], use_pallas="on")
        body = dict(cx=1.0, cy=0.05, radius=0.3)
    rs, ts = R.Simulation(rcfg), T.Simulation(tcfg, device="cpu")
    rs.set_ibm_forcing(RI.CylinderBody(**body))
    ts.set_ibm_forcing(TI.CylinderBody(**body))
    assert ts.kernels.predictor == "channel" and ts._fuse_div is False
    r = R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05)
    t = _to_port(r)
    for _ in range(5):
        r, rd = rs.step(r)
        t, td = ts.step(t)
        for f in ("fx", "fy", "fz", "dt"):
            _close_scaled(float(getattr(td, f)), float(getattr(rd, f)), f)
    out = T.state_to_numpy(t)
    for key in ("u", "v", "w", "p"):
        _close_scaled(out[key], getattr(r, key), key)
    assert float(td.fx) != 0.0
    # direct forcing can leave divergence next to the band on so coarse a
    # grid: the fluid-region value is held to the reference's, to 1e-12 of
    # it or of the velocity scale where it is at roundoff
    scale = max(float(rd.div_linf), float(np.max(np.abs(out["u"]))))
    np.testing.assert_allclose(float(td.div_linf), float(rd.div_linf),
                               rtol=0, atol=1e-12 * scale)


def test_no_body_gives_zero_forces():
    """Without a body the step's fx, fy, fz are 0-d zeros."""
    ts = T.Simulation(_cfg(T, **CHANNEL), device="cpu")
    _, d = ts.step(ts.initial_state())
    assert all(getattr(d, f).ndim == 0 and float(getattr(d, f)) == 0.0
               for f in ("fx", "fy", "fz"))


def test_ibm_takes_no_fused_divergence(monkeypatch):
    """With CFDNN_FUSE_DIV=1 the channel plans the fused divergence until a
    body is attached (an IBMBody or a ready IBMForcing), then not; the
    kernel plan itself stays."""
    monkeypatch.setenv("CFDNN_FUSE_DIV", "1")
    for attach in ("body", "forcing"):
        ts = T.Simulation(_cfg(T, **IBM_CHANNEL, use_pallas="on"),
                          device="cpu")
        assert ts._fuse_div == "channel"
        body = TI.CylinderBody(1.0, 0.05, 0.3)
        if attach == "forcing":
            body = TI.IBMForcing(ts.mesh, body, ts.cfg, device="cpu")
        ts.set_ibm_forcing(body)
        assert isinstance(ts.ibm, TI.IBMForcing)
        assert ts._fuse_div is False
        assert ts.kernels == KernelPlan("channel", "slab")


def test_tgv_re1600_config_is_the_example_file():
    """bench.tgv_re1600_config is examples/09_taylor_green_3d/
    tgv_re1600.cfg as the reference reads it, on every field the file sets,
    with perf_mode on; finalize keeps adaptive dt on (benchmark mode would
    turn it off)."""
    path = str(bench.TGV_RE1600_CFG)
    ref = R.Config.from_file(path)
    got = bench.tgv_re1600_config()
    keys = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if "=" in line:
                keys.append(line.split("=", 1)[0].strip())
    assert len(keys) == 17
    for key in keys:
        a, b = getattr(got, key), getattr(ref, key)
        a, b = getattr(a, "value", a), getattr(b, "value", b)
        assert a == b, key
    assert got.perf_mode and not got.benchmark
    fin = got.finalize()
    assert fin.adaptive_dt and fin.time_integrator == T.TimeIntegrator.RK3
    assert (fin.Nx, fin.Ny, fin.Nz, fin.CFL_xz) == (128, 128, 128, 0.6)
    # at 16^3: three steps run, dt adapts, KE decays, float64 solenoidal
    sim, st = bench.tgv_re1600_case(16, device="cpu", dtype="float64")
    ke0 = float(0.5 * sum(torch.mean(c ** 2) for c in st.velocity))
    st, d = sim.run(st, 3)
    assert float(d.ke) < ke0 and float(d.div_linf) < 1e-12
    assert float(d.dt) != fin.dt


def test_les_ibm_config_is_bench_py():
    """bench.les_ibm_config is bench.py bench_les_ibm's Config
    (bench.py:118-123), and les_ibm_case attaches its cylinder."""
    got = bench.les_ibm_config().finalize()
    ref = R.Config(
        Nx=256, Ny=128, Nz=256, x_max=4.0, z_max=2.0,
        nu=1e-4, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
        dt=2e-4, adaptive_dt=False, benchmark=True, dtype="float32",
        turb_model=R.TurbulenceModel.SMAGORINSKY).finalize()
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert getattr(a, "value", a) == getattr(b, "value", b), f.name
    sim, st = bench.les_ibm_case(16, device="cpu", dtype="float64")
    assert isinstance(sim.ibm, TI.IBMForcing)
    assert sim.ibm.body == TI.CylinderBody(1.0, 0.0, 0.25)
    st, d = sim.run(st, 2)
    assert all(np.isfinite(float(getattr(d, f))) for f in ("fx", "fy"))
