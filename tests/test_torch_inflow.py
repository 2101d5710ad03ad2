"""The port's inflow/outflow pair and outflow x (solver.py: the inflow
profile captured at `initialize` and pinned, the convective outlet, the
outlet's flux anchor; ops/kernels.py `predictor_xpad` on an INFLOW and an
OUTFLOW x), the kernel plans of the A.8 configurations, the FDM solve
with a Dirichlet x end, and the cylinder app, against the JAX reference
at float64 on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages. The
reference's Pallas kernels run in interpret mode (use_pallas="on", as
tests/test_pallas_kernels.py runs them); the port's wrappers take their
plain twins on CPU tensors. Limits: the predictor 1e-13 (the reference's
own, tests/test_pallas_kernels.py:596), the Poisson solve 1e-12 of
scale, 5-step trajectories 1e-12 of each field's scale (u, v, w, p, nu_t)
and of the force sums' scale, dt 1e-12 relative. On a CUDA card
(`cuda`): the kernel through predictor_xpad against its twin on
chip_smoke's `_xpad_cases`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu import ibm as RI
from cfdnn_tpu.apps import cylinder as r_cylinder
from cfdnn_tpu.ops import operators as RO
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu_torch import bench, ibm as TI
from cfdnn_tpu_torch.apps import cylinder
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.solver import KernelPlan

KEYS = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "k", "omega",
        "nu_t")
# the reference's test_xpad_step_trajectory_matches_jnp geometry
# (tests/test_pallas_kernels.py:607-640)
BASE = dict(Nx=24, Ny=16, Nz=8, bc_x="inflow", bc_y="periodic",
            bc_z="periodic", x_max=6.0, y_min=-2.0, y_max=2.0, z_max=1.0,
            nu=1e-2, nu_specified=True, dp_dx=0.0, dp_dx_specified=True,
            dt=5e-3, adaptive_dt=False, dtype="float64")
CASES = {
    "skew-outlet": dict(convective_outflow=True, convective_scheme="skew"),
    "central-outlet": dict(convective_outflow=True,
                           convective_scheme="central"),
    "skew-open": dict(convective_outflow=False, convective_scheme="skew"),
    "wale-rk3-adaptive": dict(convective_outflow=True,
                              convective_scheme="skew", turb_model="wale",
                              time_integrator="rk3", adaptive_dt=True,
                              CFL_max=0.4, nu=1e-3),
    "outflow-x": dict(bc_x="outflow", convective_scheme="central"),
    # a no-slip x with WALE under "on": it raised before the plan asked the
    # LES gate only where the reference's closure gate would fuse
    "wall-x-wale": dict(bc_x="wall", bc_y="wall", y_min=-1.0, y_max=1.0,
                        convective_scheme="skew", turb_model="wale",
                        dp_dx=-0.1),
}


def _cfg(pkg, **kw):
    k = dict(kw)
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


def _close(got, want, what, tol, scale=None):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    if scale is None:
        scale = max(float(np.max(np.abs(want))), 1e-300)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _start(rs, seed=5):
    """A freestream u = 1 with noise in u and v (the inlet face of it is
    the profile `initialize` captures)."""
    s0 = rs.initial_state()
    rng = np.random.default_rng(seed)
    return s0.replace(
        u=jnp.ones_like(s0.u) + 0.05 * rng.standard_normal(s0.u.shape),
        v=0.05 * jnp.asarray(rng.standard_normal(s0.v.shape)))


def _flux(sim, u_plane):
    """The area-weighted flux of a u plane (the reference's weights)."""
    wy = np.asarray(sim.mesh.y.d).reshape(-1, 1)
    wz = np.asarray(sim.mesh.z.d).reshape(1, -1)
    w = wy * wz
    return float(np.sum(np.asarray(u_plane) * w / w.sum()))


# ---------------------------------------------------------------------------
# predictor_xpad on an inflow and an outflow x
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["skew", "central"])
@pytest.mark.parametrize("with_nut", [False, True])
@pytest.mark.parametrize("bc_x", ["inflow", "outflow"])
def test_predictor_xpad_matches_pallas(bc_x, with_nut, scheme):
    """predictor_xpad and its twin on an INFLOW and an OUTFLOW x against
    the reference's fused_predictor_xpad (interpret mode), every output
    to 1e-13, and against the operators with the bc.py pads on the faces
    the solver keeps (u's boundary faces are overwritten downstream)."""
    kw = dict(BASE, Nx=12, Ny=8, Nz=8, bc_x=bc_x, convective_scheme=scheme)
    rs = R.Simulation(_cfg(R, **kw))
    ts = T.Simulation(_cfg(T, **kw), device="cpu")
    assert K.xpad_eligible(ts.geom, ts.cfg)
    rng = np.random.default_rng(3)
    comps = [rng.standard_normal(s) for s in T.velocity_shapes(ts.cfg)]
    nut = (0.1 * rng.random((12, 8, 8)) if with_nut else None)
    dt, fx = 1e-3, 0.3
    want = PK.fused_predictor_xpad(
        *(jnp.asarray(c) for c in comps), dt, geom=rs.geom,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=fx,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    tc = [torch.as_tensor(c) for c in comps]
    tn = None if nut is None else torch.as_tensor(nut)
    dt_t = torch.tensor(dt, dtype=torch.float64)
    xg = K.xpad_geometry(ts.geom)
    pkw = dict(geom=ts.geom, xgeom=xg, nu=ts.cfg.nu, fx=fx,
               scheme=ts.cfg.convective_scheme)
    twin = K.predictor_xpad_twin(*tc, dt_t, tn, **pkw)
    got = K.predictor_xpad(*tc, dt_t, K.general_arrays(xg), nu_t=tn, **pkw)
    nu_eff = ts.cfg.nu if tn is None else ts.cfg.nu + tn
    conv = T.solver.ops.convective(tuple(tc), ts.geom,
                                   ts.cfg.convective_scheme)
    diff = T.solver.ops.diffusive(tuple(tc), nu_eff, ts.geom)
    ops_star = (tc[0] + dt_t * (-conv[0] + diff[0] + fx),
                tc[1] + dt_t * (-conv[1] + diff[1]),
                tc[2] + dt_t * (-conv[2] + diff[2]))
    for name, g, t_, w, o in zip("uvw", got, twin, want, ops_star):
        _close(g, w, f"wrapper {name}", 1e-13, scale=1.0)
        _close(t_, w, f"twin {name}", 1e-13, scale=1.0)
        keep = slice(1, -1) if name == "u" else slice(None)
        _close(g[keep], o[keep], f"operators {name}", 1e-13, scale=1.0)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

_REF = {}


def _reference(case):
    """(initial state, the reference's "on" (interpret) state after 5
    steps, its diagnostics, its dts, its Simulation), once a case."""
    if case not in _REF:
        kw = dict(BASE, **CASES[case])
        rs = R.Simulation(_cfg(R, **kw, use_pallas="on"))
        assert rs._pallas_predictor_ok == "xpad"
        if case != "wall-x-wale":
            rs.set_ibm_forcing(RI.CylinderBody(1.5, 0.0, 0.4))
        s0 = _start(rs)
        r = rs.initialize(s0)
        dts = []
        for _ in range(5):
            r, rd = rs.step(r)
            dts.append(float(rd.dt))
        _REF[case] = (s0, r, rd, dts, rs)
    return _REF[case]


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_reference(case, mode):
    """5 steps of the inflow/outflow pair at 24x16x8 with an immersed
    cylinder (skew and central, with and without the convective outlet,
    WALE with RK3 at adaptive dt), an outflow x, and a no-slip x with WALE,
    port "on" (predictor_xpad's twin) and "off" against the reference's
    "on" (interpret-mode fused_predictor_xpad): each field to 1e-12 of
    its scale, the force sums to 1e-12 of theirs, each dt to 1e-12
    relative; the plan is the reference's (xpad, a plain projection, no
    closure kernel)."""
    s0, want, rd, dts, rs = _reference(case)
    kw = dict(BASE, **CASES[case])
    ts = T.Simulation(_cfg(T, **kw, use_pallas=mode), device="cpu")
    if case != "wall-x-wale":
        ts.set_ibm_forcing(TI.CylinderBody(1.5, 0.0, 0.4))
    assert ts.kernels == (KernelPlan("xpad", None, None) if mode == "on"
                          else KernelPlan(None, None))
    assert getattr(rs.turb, "_fuse", False) is False
    t = ts.initialize(_to_port(s0))
    for i in range(5):
        t, td = ts.step(t)
        np.testing.assert_allclose(float(td.dt), dts[i], rtol=1e-12, atol=0)
    out = T.state_to_numpy(t)
    for key in ("u", "v", "w", "p", "nu_t"):
        if getattr(want, key) is not None:
            _close(out[key], getattr(want, key), key, 1e-12)
    forces = [float(getattr(rd, f)) for f in ("fx", "fy", "fz")]
    scale = max(max(abs(f) for f in forces), 1e-300)
    for f, w in zip(("fx", "fy", "fz"), forces):
        assert abs(float(getattr(td, f)) - w) <= 1e-12 * scale, f
    assert float(td.div_linf) == pytest.approx(float(rd.div_linf),
                                               rel=1e-6, abs=1e-13)


# ---------------------------------------------------------------------------
# pinning and the outlet's flux anchor
# ---------------------------------------------------------------------------


def test_inflow_pinning_and_outlet_flux():
    """Before `initialize` nothing is pinned (the port's steps equal the
    reference's, whose _apply_bc finds no profile: u's inlet face is then
    the predictor's, which the xpad kernel forms on its ghost plane, so
    both run "on"); `initialize` pins the
    initial inlet face; a second `initialize` with a scaled profile pins
    the new one (the port's buffers copied in place); after every step
    the outlet face's area-weighted flux equals the inlet's."""
    kw = dict(BASE, **CASES["skew-outlet"])
    rs = R.Simulation(_cfg(R, **kw, use_pallas="on"))
    ts = T.Simulation(_cfg(T, **kw, use_pallas="on"), device="cpu")
    assert ts._inflow_profile is None
    s0 = _start(rs, seed=7)
    r, t = s0, _to_port(s0)
    for _ in range(2):
        r, _ = rs.step(r)
        t, _ = ts.step(t)
    for key in ("u", "v", "w", "p"):
        _close(getattr(t, key), getattr(r, key), key, 1e-12)
    # unpinned: the momentum update moved the inlet face
    assert not np.array_equal(np.asarray(r.u)[0], np.asarray(s0.u)[0])
    r, t = rs.initialize(s0), ts.initialize(_to_port(s0))
    held = ts._inflow_profile
    for _ in range(3):
        r, _ = rs.step(r)
        t, _ = ts.step(t)
        assert np.array_equal(t.u[0].numpy(), np.asarray(s0.u)[0])
        q_in, q_out = _flux(ts, t.u[0]), _flux(ts, t.u[-1])
        assert abs(q_out - q_in) <= 1e-12 * abs(q_in)
    for key in ("u", "v", "w", "p"):
        _close(getattr(t, key), getattr(r, key), key, 1e-12)
    # a new profile: 1.5 times the inlet face
    s1 = s0.replace(u=s0.u * 1.5)
    r, t = rs.initialize(s1), ts.initialize(_to_port(s1))
    assert ts._inflow_profile is held      # the same buffers, copied into
    for _ in range(2):
        r, _ = rs.step(r)
        t, _ = ts.step(t)
    assert np.array_equal(t.u[0].numpy(), 1.5 * np.asarray(s0.u)[0])
    for key in ("u", "v", "w", "p"):
        _close(getattr(t, key), getattr(r, key), key, 1e-12)


@pytest.mark.parametrize("bc_x,kinds", [("inflow", ("neumann", "dirichlet")),
                                        ("outflow",
                                         ("dirichlet", "dirichlet"))])
def test_poisson_with_a_dirichlet_x_end(bc_x, kinds):
    """The FDM solve on an inflow/outflow x (Neumann inlet, Dirichlet
    outlet) and an outflow x (Dirichlet at both ends) equals the
    reference's to 1e-12 of scale, and its Laplacian is the rhs."""
    kw = dict(BASE, bc_x=bc_x, Nx=12, Ny=8, Nz=6)
    rs = R.Simulation(_cfg(R, **kw))
    ts = T.Simulation(_cfg(T, **kw), device="cpu")
    assert (ts.geom.x.p_lo, ts.geom.x.p_hi) == kinds
    rhs = np.random.default_rng(9).standard_normal((12, 8, 6))
    want = np.asarray(rs.poisson.solve(jnp.asarray(rhs)))
    got = ts.poisson.solve(torch.as_tensor(rhs))
    _close(got, want, "p", 1e-12)
    lap = T.solver.ops.laplacian(got, ts.geom)
    _close(lap, np.asarray(RO.laplacian(jnp.asarray(want), rs.geom)), "Lp",
           1e-11)
    _close(lap, rhs, "Lp - rhs", 1e-10)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

CHANNEL = dict(Nx=16, Ny=24, Nz=8, stretch_y=True, z_max=1.0, nu=1e-3,
               nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
               dt=1e-3, dtype="float64")
PLANS = {
    "inflow": (dict(BASE, convective_outflow=True),
               KernelPlan("xpad", None, None)),
    "outflow": (dict(BASE, bc_x="outflow"), KernelPlan("xpad", None, None)),
    "inflow-wale": (dict(BASE, turb_model="wale"),
                    KernelPlan("xpad", None, None)),
    "implicit-y": (dict(CHANNEL, implicit_y_diffusion=True),
                   KernelPlan(None, None, None)),
    "implicit-y-wale": (dict(CHANNEL, implicit_y_diffusion=True,
                             turb_model="wale"),
                        KernelPlan(None, None, "nu_sgs")),
    "implicit-y-sst": (dict(CHANNEL, implicit_y_diffusion=True,
                            turb_model="sst"),
                       KernelPlan(None, None, None)),
    "ramp": (dict(CHANNEL, force_ramp_time=1.0),
             KernelPlan(None, "slab", None)),
    "ramp-sst": (dict(CHANNEL, force_ramp_time=1.0, turb_model="sst"),
                 KernelPlan(None, "slab", "transport")),
    "bulk-wale": (dict(CHANNEL, bulk_velocity_target=1.0,
                       turb_model="wale"),
                  KernelPlan(None, "slab", "nu_sgs")),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_is_the_references(name):
    """Under use_pallas="on" the plan launches what the reference's does:
    its mode (_pallas_predictor_ok) gives the predictor kernel unless a
    force ramp or bulk control runs it plain; the projection kernels on a
    periodic x of its "slab" mode; its LES closure's own gate
    (turb._fuse) and its transport's (the "slab" mode). "on" raises on
    none of these."""
    kw, plan = PLANS[name]
    rs = R.Simulation(_cfg(R, **kw, use_pallas="on"))
    ts = T.Simulation(_cfg(T, **kw, use_pallas="on"), device="cpu")
    assert ts.kernels == plan
    mode = rs._pallas_predictor_ok
    ramp = kw.get("force_ramp_time", 0) > 0 or kw.get(
        "bulk_velocity_target", 0) > 0
    assert (ts.kernels.predictor is not None) == (bool(mode) and not ramp)
    assert (ts.kernels.predictor == "xpad") == (mode == "xpad")
    assert (ts.kernels.projection == "slab") == (
        mode == "slab" and rs.geom.axes[0].periodic)
    if hasattr(rs.turb, "_fuse_mode"):
        assert (ts.kernels.closure == "transport") == bool(
            rs.turb._fuse_mode(rs))
    else:
        assert (ts.kernels.closure == "nu_sgs") == bool(
            getattr(rs.turb, "_fuse", False))
    # what a CUDA device would plan under "auto"
    ts.device = torch.device("cuda", 0)
    ts.cfg = ts.cfg.with_(use_pallas="auto")
    assert ts._select_kernels() == plan


# ---------------------------------------------------------------------------
# the cylinder app and the bench's LES cylinder
# ---------------------------------------------------------------------------

APP_ARGS = {
    "default": ["--Nx", "32", "--Ny", "16", "--dtype", "float64"],
    "external": ["--external", "--Nx", "40", "--Ny", "32", "--x_max",
                 "10.0", "--dtype", "float64"],
}
COMMON = ["--max_steps", "20", "--output_freq", "10", "--num_snapshots",
          "0", "--verbose", "false", "--write_fields", "false",
          "--platform", "cpu"]


def _qois(text):
    import json
    return {d["name"]: d["value"] for d in
            (json.loads(line.split("QOI_JSON: ", 1)[1])
             for line in text.splitlines() if line.startswith("QOI_JSON: "))}


@pytest.mark.parametrize("which", sorted(APP_ARGS))
def test_cylinder_app_matches_reference(which, tmp_path, capsys):
    """`apps.cylinder.main(argv)`, the periodic default (IBM, RK2,
    adaptive dt) and `--external` (the inflow/outflow pair with
    external_ic), 20 steps on the CPU: its QOIs to 1e-10 relative of the
    reference app's, the final fields to 1e-12 of their scale, and on the
    external case the inlet face the pinned profile. The default's
    cylinder sits on the channel's centre line, so its 20-step lift is
    roundoff whose zero crossings give no Strouhal number: there the
    Strouhal QOI is only checked to be present."""
    argv = APP_ARGS[which] + COMMON + ["--output_dir", str(tmp_path) + "/"]
    sim, st, d = cylinder.main(argv)
    got = _qois(capsys.readouterr().out)
    rsim, rst, rd = r_cylinder.main(argv)
    want = _qois(capsys.readouterr().out)
    assert sim.device.type == "cpu" and int(st.step) == int(rst.step) == 20
    assert set(got) == set(want) and got
    for k, w in want.items():
        if which == "default" and k.endswith("strouhal"):
            continue
        np.testing.assert_allclose(got[k], w, rtol=1e-10, atol=1e-300,
                                   err_msg=k)
    for k in ("u", "v", "w", "p"):
        _close(getattr(st, k), getattr(rst, k), k, 1e-12)
    if which == "external":
        assert sim.kernels == KernelPlan(None, None)
        assert torch.equal(st.u[0], torch.ones_like(st.u[0]))


def test_les_cylinder_config_is_the_validation_script():
    """bench.les_cylinder_config is validation/run_les_cylinder3900.py's
    Config (:36-51), field for field; les_cylinder_case at 32x24x4 runs
    3 float64 steps on the CPU with its inlet pinned and the outlet's
    flux equal to the inlet's."""
    ref = R.Config(
        Nx=256, Ny=192, Nz=32, x_min=0.0, x_max=25.0, y_min=-8.0,
        y_max=8.0, z_min=0.0, z_max=float(np.pi),
        bc_x=R.BCType.INFLOW, bc_y=R.BCType.PERIODIC, bc_z=R.BCType.PERIODIC,
        nu=1.0 / 3900.0, nu_specified=True, dp_dx=0.0, dp_dx_specified=True,
        dt=1e-3, adaptive_dt=True, CFL_max=0.4, dt_safety=0.9,
        time_integrator=R.TimeIntegrator.RK3,
        convective_scheme=R.ConvectiveScheme.SKEW,
        turb_model=R.TurbulenceModel.WALE, convective_outflow=True,
        dtype="float32").finalize()
    cfg = bench.les_cylinder_config().finalize()
    for f in ("Nx", "Ny", "Nz", "x_min", "x_max", "y_min", "y_max", "z_min",
              "z_max", "nu", "dp_dx", "dt", "adaptive_dt", "CFL_max",
              "CFL_xz", "dt_safety", "convective_outflow", "dtype"):
        assert getattr(cfg, f) == getattr(ref, f), f
    for f in ("bc_x", "bc_y", "bc_z", "time_integrator",
              "convective_scheme", "turb_model"):
        assert getattr(cfg, f).value == getattr(ref, f).value, f
    assert cfg.perf_mode
    sim, st = bench.les_cylinder_case(32, device="cpu", dtype="float64",
                                      Nz=4)
    u0 = st.u[0].clone()
    st, d = sim.run(st, 3)
    assert torch.equal(st.u[0], u0)
    assert abs(_flux(sim, st.u[-1]) - _flux(sim, st.u[0])) <= 1e-12
    assert np.isfinite(float(d.ke)) and float(d.div_linf) < 1e-10


@pytest.mark.cuda
def test_xpad_kernel_matches_twin_on_cuda():
    """On a CUDA card: predictor_general through predictor_xpad on an
    INFLOW and an OUTFLOW x against its twin (chip_smoke._xpad_cases,
    through chip_smoke._hold) at the LES cylinder's 256x192x32 and at
    9x5x32, float64 to 1e-12 and float32 to 1e-5 of each output's
    scale, every input and output between NaN bands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    errs = {}
    for dtype in (torch.float64, torch.float32):
        cases = chip_smoke._xpad_cases(dtype, dev, seed=5)
        assert len(cases) == 8 * len(chip_smoke._XPAD_GRIDS)
        for case in cases:
            assert case.banded, case.label
            chip_smoke._hold(case, dtype, errs)
