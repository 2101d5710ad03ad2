"""The port's upwind and upwind2 momentum schemes (ops/operators.py, the
general predictor's slab, "xz" and xpad kernels through their twins, the
kernel plans and the steps they carry) against the JAX reference at
float64 on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages. The
reference's Pallas kernels run as its own tests run them
(`fused_*(..., interpret=True)`, tests/test_pallas_kernels.py:678-712);
the port's wrappers take their plain twins on CPU tensors. Every
comparison is held to 1e-12 of the reference's scale (the largest
magnitude of the field compared; a trajectory's p, which the Poisson
solve carries at a scale dt below the velocity's, to 1e-12 of the larger
of its own and the velocity's, as tests/test_torch_xz.py holds it). The
convergence orders mirror tests/test_convergence.py:55-89. On a CUDA card (`cuda`): every upwind
variant of the kernels against its twin on chip_smoke's `_upwind_cases`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu import ibm as RI
from cfdnn_tpu.mesh import Mesh as RMesh
from cfdnn_tpu.ops import operators as RO
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu.ops.grid import Geometry as RGeometry
from cfdnn_tpu_torch import ibm as TI
from cfdnn_tpu_torch import solver as TS
from cfdnn_tpu_torch.mesh import Mesh as TMesh
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.ops import operators as TO
from cfdnn_tpu_torch.ops.grid import Geometry as TGeometry
from cfdnn_tpu_torch.solver import KernelPlan

TOL = 1e-12
SCHEMES = ("upwind", "upwind2")
PHYS = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
            dt=1e-3, adaptive_dt=False, dtype="float64")
WALLS = dict(y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0)
PERIODIC = dict(Nx=16, Ny=16, Nz=16, bc_y="periodic", y_min=0.0, y_max=1.0,
                x_max=1.0, z_max=2.0)
CHANNEL = dict(Nx=16, Ny=24, Nz=8, stretch_y=True, z_max=1.0)
DUCT = dict(WALLS, Nx=16, Ny=12, Nz=12, x_max=4.0, bc_z="wall",
            stretch_y=True, stretch_z=True)
LID = dict(Nx=16, Ny=12, Nz=8, y_min=0.0, y_max=1.0, x_max=2.0, z_max=1.0,
           lid_velocity=1.3)
INFLOW = dict(Nx=16, Ny=12, Nz=8, bc_x="inflow", bc_y="periodic", x_max=4.0,
              y_min=-1.0, y_max=1.0, z_max=1.0)
# the geometries of the operator comparison: (grid, space order)
GEOMETRIES = {
    "periodic": (PERIODIC, 2),
    "channel": (CHANNEL, 2),
    "duct": (DUCT, 2),
    "lid": (LID, 2),
    "inflow-x": (INFLOW, 2),
    "o4-periodic": (PERIODIC, 4),
    "o4-channel": (CHANNEL, 4),
}


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


def _sims(**kw):
    return R.Simulation(_cfg(R, **kw)), T.Simulation(_cfg(T, **kw),
                                                      device="cpu")


def _inputs(cfg, seed, with_nut=False):
    rng = np.random.default_rng(seed)
    comps = [rng.standard_normal(s) for s in T.velocity_shapes(cfg)]
    # advecting velocities of both signs and exact ties (adv = 0 takes the
    # backward difference)
    comps[0].reshape(-1)[::7] = 0.0
    cells = (cfg.Nx, cfg.Ny, cfg.Nz)
    nut = 1e-2 * np.abs(rng.standard_normal(cells)) if with_nut else None
    return comps, nut


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, what):
    """Each of `got` to TOL of its reference's scale."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        scale = max(float(np.max(np.abs(w))), 1e-300)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale,
                                   err_msg=what)


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_convective_matches_reference(geometry, scheme):
    """ops.convective with upwind and upwind2 against the reference's on
    the periodic box, the stretched channel, the duct, a lid, an
    inflow/outflow x and the O4 box and channel (O4 advecting velocity,
    upwind derivatives)."""
    grid, order = GEOMETRIES[geometry]
    rcfg = _cfg(R, **grid, space_order=order,
                convective_scheme=scheme).finalize()
    tcfg = _cfg(T, **grid, space_order=order,
                convective_scheme=scheme).finalize()
    rg = RGeometry.make(RMesh.from_config(rcfg), rcfg)
    tg = TGeometry.make(TMesh.from_config(tcfg), tcfg, device="cpu")
    comps, _ = _inputs(tcfg, 3)
    want = RO.convective(tuple(jnp.asarray(c) for c in comps), rg,
                         rcfg.convective_scheme)
    got = TO.convective(tuple(_t(c) for c in comps), tg,
                        tcfg.convective_scheme)
    _close(got, want, f"{scheme} on {geometry}")


def _rate(errs, ns):
    return -np.polyfit(np.log(ns), np.log(errs), 1)[0]


@pytest.mark.parametrize("scheme,linf_order,l2_order", [
    ("upwind", 1.0, 1.0),
    ("upwind2", 1.0, 1.5),     # minmod clips at smooth extrema: O(h) in a
])                             # width-O(h) band -> Linf 1, L2 1.5
def test_upwind_convective_order(scheme, linf_order, l2_order):
    """u du/dx for u = 2 + sin(x) on a periodic axis converges at the
    reference's orders (tests/test_convergence.py:55-89): the port's
    upwind2 is the consistent MUSCL difference, not the C++ code's
    increment that plateaus at ~0.5."""
    errs_inf, errs_2, ns = [], [], [32, 64, 128]
    for n in ns:
        cfg = T.Config(Nx=n, Ny=8, Nz=1, bc_x=T.BCType.PERIODIC, nu=1e-3,
                       nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
                       dtype="float64",
                       convective_scheme=T.ConvectiveScheme(scheme))
        mesh = TMesh.from_config(cfg)
        geom = TGeometry.make(mesh, cfg, device="cpu")
        xf = mesh.x.faces[:-1]
        u = torch.from_numpy(np.broadcast_to(
            (2.0 + np.sin(xf)).reshape(n, 1, 1), (n, 8, 1)).copy())
        v = torch.zeros((n, 9, 1), dtype=torch.float64)
        w = torch.zeros((n, 8, 1), dtype=torch.float64)
        conv = TO.convective((u, v, w), geom, cfg.convective_scheme)[0]
        exact = ((2.0 + np.sin(xf)) * np.cos(xf)).reshape(n, 1, 1)
        e = conv.numpy() - exact
        errs_inf.append(np.abs(e).max())
        errs_2.append(np.sqrt((e ** 2).mean()))
    assert _rate(errs_inf, ns) > linf_order - 0.15, errs_inf
    assert _rate(errs_2, ns) > l2_order - 0.15, errs_2
    assert errs_inf[-1] < (0.1 if scheme == "upwind" else 0.05)


# ---------------------------------------------------------------------------
# the kernels' twins against the reference's interpret-mode kernels
# ---------------------------------------------------------------------------

# (grid, space order, with nu_t) of the slab kernel's comparison
SLAB_GRIDS = {
    "periodic-nut": (PERIODIC, 2, True),
    "channel-nut": (CHANNEL, 2, True),
    "duct": (DUCT, 2, False),
    "lid": (LID, 2, False),
    "o4-periodic": (PERIODIC, 4, False),
    "o4-channel-nut": (CHANNEL, 4, True),
}


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("grid", sorted(SLAB_GRIDS))
def test_predictor_general_matches_pallas(grid, scheme):
    """predictor_general_twin and the predictor_general wrapper (its twin
    on the CPU) against the reference's fused_predictor_general in
    interpret mode: every star."""
    kw, order, with_nut = SLAB_GRIDS[grid]
    rs, ts = _sims(**kw, space_order=order, convective_scheme=scheme)
    assert K.general_eligible(ts.geom, ts.cfg)
    comps, nut = _inputs(ts.cfg, 1, with_nut)
    dt, fx = 1e-2, 0.7
    want = PK.fused_predictor_general(
        *(jnp.asarray(c) for c in comps), dt, geom=rs.geom,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=fx,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    u, v, w = (_t(c) for c in comps)
    dt_t = torch.tensor(dt, dtype=torch.float64)
    kg = dict(geom=ts.geom, nu=ts.cfg.nu, fx=fx,
              scheme=ts.cfg.convective_scheme)
    _close(K.predictor_general_twin(u, v, w, dt_t, _t(nut), **kg), want,
           "twin")
    _close(K.predictor_general(u, v, w, dt_t, K.general_arrays(ts.geom),
                               nu_t=_t(nut), **kg), want, "wrapper")


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("y_axis", ["wall-stretched", "periodic"])
def test_predictor_general_xz_matches_pallas(y_axis, scheme):
    """predictor_general_xz (its twin on the CPU) against the reference's
    fused_predictor_general_xz in interpret mode at 16x24x32 (its xz
    tests' grid), a walled stretched and a periodic y, with nu_t."""
    kw = dict(Nx=16, Ny=24, Nz=32)
    if y_axis == "periodic":
        kw.update(bc_y="periodic", y_min=0.0, y_max=1.0)
    else:
        kw.update(stretch_y=True)
    rs, ts = _sims(**kw, convective_scheme=scheme)
    assert K.xz_eligible(ts.geom)
    comps, nut = _inputs(ts.cfg, 11, True)
    dt, fx = 1e-3, 0.5
    want = PK.fused_predictor_general_xz(
        *(jnp.asarray(c) for c in comps), dt, geom=rs.geom,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=fx,
        nu_t=jnp.asarray(nut), interpret=True)
    assert want is not None
    u, v, w = (_t(c) for c in comps)
    dt_t = torch.tensor(dt, dtype=torch.float64)
    _close(K.predictor_general_xz(u, v, w, dt_t, K.general_arrays(ts.geom),
                                  nu_t=_t(nut), geom=ts.geom, nu=ts.cfg.nu,
                                  fx=fx, scheme=ts.cfg.convective_scheme),
           want, "wrapper")


@pytest.mark.parametrize("with_nut", [False, True])
@pytest.mark.parametrize("bc_x", ["wall", "inflow", "outflow"])
def test_predictor_xpad_matches_pallas(bc_x, with_nut):
    """predictor_xpad with upwind (its twin on the CPU) against the
    reference's fused_predictor_xpad in interpret mode on a no-slip, an
    inflow/outflow and an outflow x: every star."""
    kw = dict(INFLOW, bc_x=bc_x, convective_scheme="upwind")
    rs, ts = _sims(**kw)
    assert K.xpad_eligible(ts.geom, ts.cfg)
    comps, nut = _inputs(ts.cfg, 3, with_nut)
    dt, fx = 1e-3, 0.4
    want = PK.fused_predictor_xpad(
        *(jnp.asarray(c) for c in comps), dt, geom=rs.geom,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=fx,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    u, v, w = (_t(c) for c in comps)
    dt_t = torch.tensor(dt, dtype=torch.float64)
    xg = K.xpad_geometry(ts.geom)
    kg = dict(geom=ts.geom, xgeom=xg, nu=ts.cfg.nu, fx=fx,
              scheme=ts.cfg.convective_scheme)
    _close(K.predictor_xpad(u, v, w, dt_t, K.general_arrays(xg),
                            nu_t=_t(nut), **kg), want, "wrapper")


def test_wrappers_refuse_what_the_reference_refuses():
    """predictor_xpad refuses upwind2 (its stencil reaches past the pad's
    one ghost plane), the channel predictor refuses the upwind schemes (as
    the reference's channel_slab_eligible), and the general wrappers take
    all four schemes."""
    _, ts = _sims(**dict(INFLOW, convective_scheme="upwind2"))
    assert not K.xpad_eligible(ts.geom, ts.cfg)
    comps, _ = _inputs(ts.cfg, 2)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    xg = K.xpad_geometry(ts.geom)
    with pytest.raises(NotImplementedError, match="upwind2"):
        K.predictor_xpad(*(_t(c) for c in comps), dt, K.general_arrays(xg),
                         geom=ts.geom, xgeom=xg, nu=1e-3, fx=0.0,
                         scheme=T.ConvectiveScheme.UPWIND2)
    _, ch = _sims(**CHANNEL, convective_scheme="upwind")
    assert not K.channel_slab_eligible(ch.geom, ch.cfg)
    u, v, w = (_t(c) for c in _inputs(ch.cfg, 2)[0])
    for scheme in (T.ConvectiveScheme.UPWIND, T.ConvectiveScheme.UPWIND2):
        with pytest.raises(NotImplementedError, match="skew and central"):
            K.predictor_channel(u, v, w, dt, K.channel_y_arrays(ch.geom),
                                hx=ch.geom.x.h, hz=ch.geom.z.h, nu=1e-3,
                                fx=0.0, scheme=scheme)
    assert set(K.SCHEME_CODES) == set(T.ConvectiveScheme)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------


def _cuda_plan(monkeypatch=None, cap=None, **kw):
    """The plan a CUDA device would get under "auto" (a plan allocates
    nothing), with the slab cap lowered in both packages where `cap`."""
    if cap is not None:
        monkeypatch.setattr(TS, "SLAB_FIT_CELLS", cap)
        monkeypatch.setattr(PK, "_SLAB_FIT_CELLS", cap)
    sim = T.Simulation(_cfg(T, **kw), device="cpu")
    assert sim.kernels == KernelPlan(None, None)
    sim.device = torch.device("cuda", 0)
    return sim._select_kernels()


def _reference_mode(**kw):
    """The reference's mode under "on" (its _pallas_eligible)."""
    return R.Simulation(_cfg(R, **kw, use_pallas="on"))._pallas_predictor_ok


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("order", [2, 4])
def test_channel_plans_the_general_predictor(order, scheme):
    """The 128^3 channel of scripts/measure_upwind.py (at 16^3 here), O2
    and O4: ("general", "slab"), as the reference's "slab" mode with its
    fused_predictor_general (never the channel kernel: channel_slab_eligible
    takes skew and central only)."""
    kw = dict(Nx=16, Ny=16, Nz=16, stretch_y=True, space_order=order,
              convective_scheme=scheme)
    assert _cuda_plan(**kw) == KernelPlan("general", "slab", None)
    assert _reference_mode(**kw) == "slab"
    assert not PK.channel_slab_eligible(
        R.Simulation(_cfg(R, **kw)).geom, _cfg(R, **kw).finalize())


def test_xz_halo_of_two(monkeypatch):
    """Above the slab cap on a prime Nx = 11 (an (x, z) tiling at a halo
    of 1, none at 2): upwind takes the xz kernels, upwind2 no mode at all,
    as the reference's _auto_bxz at _scheme_ng's halo."""
    kw = dict(Nx=11, Ny=12, Nz=32, stretch_y=True)
    assert _cuda_plan(monkeypatch, 8, **kw, convective_scheme="upwind") \
        == KernelPlan("general_xz", "xz", None)
    assert _reference_mode(**kw, convective_scheme="upwind") == "xz"
    assert _cuda_plan(monkeypatch, 8, **kw, convective_scheme="upwind2") \
        == KernelPlan(None, None, None)
    assert _reference_mode(**kw, convective_scheme="upwind2") is False
    kw["Nx"] = 16
    assert _cuda_plan(monkeypatch, 8, **kw, convective_scheme="upwind2") \
        == KernelPlan("general_xz", "xz", None)


def test_xpad_takes_upwind_and_not_upwind2():
    """A uniform inflow/outflow x: upwind plans xpad (the reference's xpad
    mode); upwind2 has no mode (the reference's xpad gate refuses it), so
    "on" raises and "auto" runs the plain step."""
    assert _cuda_plan(**INFLOW, convective_scheme="upwind") \
        == KernelPlan("xpad", None, None)
    assert _reference_mode(**INFLOW, convective_scheme="upwind") == "xpad"
    assert _cuda_plan(**INFLOW, convective_scheme="upwind2") \
        == KernelPlan(None, None, None)
    assert _reference_mode(**INFLOW, convective_scheme="upwind2") is False
    with pytest.raises(NotImplementedError, match="no ported kernel"):
        T.Simulation(_cfg(T, **INFLOW, convective_scheme="upwind2",
                          use_pallas="on"), device="cpu")
    sim = T.Simulation(_cfg(T, **INFLOW, convective_scheme="upwind2"),
                       device="cpu")
    st, d = sim.run(sim.initialize(sim.initial_state()), 2)
    assert bool(torch.isfinite(st.u).all()) and float(d.div_linf) < 1e-10


def test_rans_and_les_closures_keep_their_kernels():
    """Under upwind the SST channel keeps its transport kernel and the
    WALE duct its nu_sgs beside the general predictor; CFDNN_FUSE_DIV
    stays off (no periodic or channel predictor)."""
    assert _cuda_plan(**CHANNEL, convective_scheme="upwind",
                      turb_model="sst") \
        == KernelPlan("general", "slab", "transport")
    assert _cuda_plan(**DUCT, convective_scheme="upwind2",
                      turb_model="wale") \
        == KernelPlan("general", "slab", "nu_sgs")


def test_fused_divergence_stays_off(monkeypatch):
    """With CFDNN_FUSE_DIV=1 an upwind channel runs unfused, as the
    reference's _fuse_div_eligible keeps it."""
    monkeypatch.setenv("CFDNN_FUSE_DIV", "1")
    for scheme in SCHEMES:
        sim = T.Simulation(_cfg(T, **CHANNEL, convective_scheme=scheme,
                                use_pallas="on"), device="cpu")
        assert sim.kernels.predictor == "general" and not sim._fuse_div
        rs = R.Simulation(_cfg(R, **CHANNEL, convective_scheme=scheme,
                               use_pallas="on"))
        assert not rs._fuse_div_eligible()


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

KEYS = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "k", "omega",
        "nu_t")
TRAJECTORIES = {
    "channel-upwind2-rk3": (dict(CHANNEL, Nx=16, Ny=12, nu=1e-3,
                                 dp_dx=-1e-3, convective_scheme="upwind2",
                                 time_integrator="rk3"), "general", None),
    "duct-upwind-wale": (dict(DUCT, nu=1e-4, dp_dx=-1e-3, dt=2e-4,
                              convective_scheme="upwind",
                              turb_model="wale"), "general", "nu_sgs"),
    "sst-channel-upwind": (dict(CHANNEL, Nx=16, Ny=12, nu=1e-4,
                                dp_dx=-1e-3, dt=2e-4,
                                convective_scheme="upwind",
                                turb_model="sst"), "general", "transport"),
    "o4-tgv-upwind2": (dict(Nx=16, Ny=16, Nz=16, bc_y="periodic",
                            y_min=0.0, y_max=2 * np.pi, z_max=2 * np.pi,
                            x_max=2 * np.pi, nu=1.0 / 1600.0, dp_dx=0.0,
                            space_order=4, convective_scheme="upwind2"),
                       "general", None),
}


def _to_port(state):
    return T.state_from_numpy(
        {k: np.asarray(getattr(state, k)) for k in KEYS
         if getattr(state, k) is not None}, "cpu", torch.float64)


def _compare_fields(t, r):
    """Each field to TOL of its scale; p, which the Poisson solve carries
    at a scale dt below the velocity's, to TOL of the larger of its own
    and the velocity's (as tests/test_torch_xz.py holds it)."""
    out = T.state_to_numpy(t)
    for key in ("u", "v", "w", "k", "omega", "nu_t"):
        if getattr(r, key) is not None:
            _close(out[key], getattr(r, key), key)
    vel = max(float(np.max(np.abs(np.asarray(getattr(r, c)))))
              for c in "uvw")
    scale = max(float(np.max(np.abs(np.asarray(r.p)))), vel)
    np.testing.assert_allclose(out["p"], np.asarray(r.p), rtol=0,
                               atol=TOL * scale, err_msg="p")


@pytest.mark.parametrize("case", sorted(TRAJECTORIES))
def test_trajectory_matches_reference(case):
    """5 steps of the port under use_pallas="on" (the general predictor's
    twin, the slab projection's, the closure kernel's) against the
    reference's operator chain ("off") from the same initial state: the
    upwind2 channel with RK3, the WALE duct with upwind, the SST channel
    with upwind, the O4 Taylor-Green with upwind2; every field to 1e-12
    of its scale (p of the larger of its own and the velocity's)."""
    kw, predictor, closure = TRAJECTORIES[case]
    rs = R.Simulation(_cfg(R, **kw, use_pallas="off"))
    ts = T.Simulation(_cfg(T, **kw, use_pallas="on"), device="cpu")
    assert ts.kernels == KernelPlan(predictor, "slab", closure)
    if case.startswith("o4-tgv"):
        r = R.init_taylor_green(rs.cfg, rs.mesh)
    else:
        r = R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05)
    r = rs.initialize(r)
    t = _to_port(r)
    for _ in range(5):
        r, rd = rs.step(r)
        t, td = ts.step(t)
        assert float(td.dt) == pytest.approx(float(rd.dt), rel=1e-12)
    _compare_fields(t, r)
    assert float(td.div_linf) < 1e-10


_CYL = {}


@pytest.mark.parametrize("mode", ["on", "off"])
def test_inflow_cylinder_trajectory_matches_reference(mode):
    """5 steps of the inflow/outflow pair with the convective outlet and an
    immersed cylinder under upwind, the port "on" (predictor_xpad's twin)
    and "off" against the reference's "on" (its interpret-mode
    fused_predictor_xpad): every field and the force sums to 1e-12 of
    their scale (p of the larger of its own and the velocity's)."""
    kw = dict(INFLOW, Nx=24, Ny=16, x_max=6.0, y_min=-2.0, y_max=2.0,
              nu=1e-2, dp_dx=0.0, dt=5e-3, convective_outflow=True,
              convective_scheme="upwind")
    if not _CYL:
        rs = R.Simulation(_cfg(R, **kw, use_pallas="on"))
        assert rs._pallas_predictor_ok == "xpad"
        rs.set_ibm_forcing(RI.CylinderBody(1.5, 0.0, 0.4))
        s0 = rs.initial_state()
        rng = np.random.default_rng(5)
        s0 = s0.replace(
            u=jnp.ones_like(s0.u) + 0.05 * rng.standard_normal(s0.u.shape),
            v=0.05 * jnp.asarray(rng.standard_normal(s0.v.shape)))
        r = rs.initialize(s0)
        for _ in range(5):
            r, rd = rs.step(r)
        _CYL.update(s0=s0, r=r, rd=rd)
    ts = T.Simulation(_cfg(T, **kw, use_pallas=mode), device="cpu")
    ts.set_ibm_forcing(TI.CylinderBody(1.5, 0.0, 0.4))
    assert ts.kernels == (KernelPlan("xpad", None, None) if mode == "on"
                          else KernelPlan(None, None))
    t = ts.initialize(_to_port(_CYL["s0"]))
    for _ in range(5):
        t, td = ts.step(t)
    _compare_fields(t, _CYL["r"])
    rd = _CYL["rd"]
    forces = [float(getattr(rd, f)) for f in ("fx", "fy", "fz")]
    scale = max(max(abs(f) for f in forces), 1e-300)
    for f, w in zip(("fx", "fy", "fz"), forces):
        assert abs(float(getattr(td, f)) - w) <= TOL * scale, f


# ---------------------------------------------------------------------------
# on a CUDA card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_upwind_kernels_match_twins_on_cuda():
    """On a CUDA card: every upwind and upwind2 variant of the general
    predictor's kernels (slab, wide, xz, O4, xpad) against its twin on
    chip_smoke's `_upwind_cases` through chip_smoke._hold, float64 to
    1e-12 of scale (the xz kernels 1e-13, also against the slab kernel),
    float32 to 1e-5, with the inputs and outputs between NaN bands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    errs = {}
    for dtype in (torch.float64, torch.float32):
        for case in chip_smoke._upwind_cases(dtype, dev, seed=4):
            chip_smoke._hold(case, dtype, errs)
    assert errs["upwind"]["predictor_general"][0] >= 0.0
