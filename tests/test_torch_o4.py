"""The port's fourth-order space discretization (space_order=4) against the
JAX package, at float64 on the CPU.

The same NumPy-seeded inputs go through both packages:
  - the O4 gates of each axis (o4_ok, use_o4), a periodic axis of 3 cells
    staying O2 and ones of 4 and 5 (the stencils' wrap collisions) taking
    O4;
  - the six O4 stencils and the operators that use them (convective skew
    and central, diffusive with a scalar nu and with nu_t, divergence,
    pressure_grad_face, correct_velocity, laplacian) on the periodic box,
    a stretched channel, a duct and boxes of 3, 4 and 5 cells, to 1e-12;
  - the O4 FDM solves ("fft", "matmul", "fht", "pallas_fft") and the
    Laplacian of a solve against the rhs less its null component;
  - the O2-only kernels' refusal of an O4 geometry;
  - each path's kernel plan against the reference's kernel choice (the
    periodic predictor never at O4, an "xz" grid on the O4 xz kernels);
  - the O4 divergence's rate of convergence on the port.
The O4 kernel wrappers are held to the reference's interpret-mode kernels
in tests/test_torch_o4_kernels.py, the O4 paths' trajectories in
tests/test_torch_o4_traj.py (three files, so that the test run's workers
share them), the O4 xz kernels, plan and trajectories in
tests/test_torch_xz_o4.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.mesh import Mesh as RMesh
from cfdnn_tpu.ops import operators as rops
from cfdnn_tpu.ops.grid import Geometry as RGeometry
from cfdnn_tpu.poisson.fdm import FDMPoissonSolver as RFDM
from cfdnn_tpu_torch import bench
from cfdnn_tpu_torch import solver as TS
from cfdnn_tpu_torch.mesh import Mesh as TMesh
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.ops import operators as tops
from cfdnn_tpu_torch.ops.grid import Geometry as TGeometry
from cfdnn_tpu_torch.poisson.fdm import FDMPoissonSolver as TFDM
from cfdnn_tpu_torch.solver import KernelPlan

ATOL = 1e-12
PHYS = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
            dt=1e-3, adaptive_dt=False, dtype="float64", space_order=4)
BOX = dict(bc_x="periodic", bc_y="periodic", bc_z="periodic", y_min=0.0,
           y_max=1.0, x_max=1.0, z_max=2.0)
# grid: (config, whether x, y, z take O4)
GRIDS = {
    "box16": (dict(BOX, Nx=16, Ny=16, Nz=16), (True, True, True)),
    "channel": (dict(Nx=16, Ny=24, Nz=8, stretch_y=True, z_max=1.0),
                (True, False, True)),
    "duct": (dict(Nx=16, Ny=12, Nz=12, y_min=-1.0, y_max=1.0, z_min=-1.0,
                  z_max=1.0, bc_z="wall", stretch_y=True, stretch_z=True),
             (True, False, False)),
    # a periodic axis of 3 cells stays O2; 4 and 5 take O4 with the
    # stencils' reads colliding across the wrap
    "box_n3_n4": (dict(BOX, Nx=16, Ny=3, Nz=4), (True, False, True)),
    "box_n5": (dict(BOX, Nx=5, Ny=16, Nz=5), (True, True, True)),
}
ENUMS = (("bc_x", "BCType"), ("bc_y", "BCType"), ("bc_z", "BCType"),
         ("convective_scheme", "ConvectiveScheme"),
         ("turb_model", "TurbulenceModel"),
         ("time_integrator", "TimeIntegrator"),
         ("poisson_solver", "PoissonSolverType"))


def _cfg(pkg, **kw):
    k = dict(PHYS, **kw)
    for name, enum_ in ENUMS:
        if name in k and isinstance(k[name], str):
            k[name] = getattr(pkg, enum_)(k[name])
    return pkg.Config(**k)


def _ref_cfg(tcfg, **over):
    """The reference's Config of the port's `tcfg` (the same fields)."""
    fields = {f.name: getattr(tcfg, f.name)
              for f in dataclasses.fields(tcfg)}
    for name, enum_ in ENUMS:
        if fields.get(name) is not None:
            fields[name] = getattr(R, enum_)(fields[name].value)
    fields.update(over)
    return R.Config(**fields)


def _geoms(grid):
    kw = GRIDS[grid][0]
    rcfg, tcfg = _cfg(R, **kw).finalize(), _cfg(T, **kw).finalize()
    return (RGeometry.make(RMesh.from_config(rcfg), rcfg),
            TGeometry.make(TMesh.from_config(tcfg), tcfg, device="cpu"),
            tcfg)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    comps = [rng.standard_normal(s) for s in T.velocity_shapes(cfg)]
    cells = (cfg.Nx, cfg.Ny, cfg.Nz)
    return comps, rng.standard_normal(cells), 1e-2 * np.abs(
        rng.standard_normal(cells))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, atol=ATOL):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, f"{what}: {g.shape} vs {w.shape}"
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# Geometry and operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_o4_axes_match_reference(grid):
    """o4_ok and use_o4 of each axis equal the reference's and the grid's
    declared O4 axes; each o4_ok axis carries its 24 h divisor."""
    rg, tg, _ = _geoms(grid)
    want = GRIDS[grid][1]
    for a, (ra, ta) in enumerate(zip(rg.axes, tg.axes)):
        assert ta.o4_ok == ra.o4_ok
        assert tg.use_o4(a) == rg.use_o4(a) == want[a], a
        if ta.o4_ok:
            assert torch.all(ta.o4_den == 24.0 * ta.h)
        else:
            assert ta.o4_den is None
    o2 = dataclasses.replace(tg, space_order=2)
    assert not any(o2.use_o4(a) for a in range(3))


STENCILS = ("f2c_mean4", "f2c_diff4", "c2f_mean4", "c2f_diff4",
            "same_diff4", "same_diff2_4")
OPERATORS = ("stencils", "convective_skew", "convective_central",
             "diffusive_nu", "diffusive_nu_t", "divergence",
             "pressure_grad_face", "correct_velocity", "laplacian")


def _operator(name, ops, geom, comps, p, nut):
    """Operator `name` of the library `ops` on one package's inputs."""
    if name == "stencils":
        return [getattr(ops, s)(comps[0], a, geom.axes[a])
                for s in STENCILS for a in range(3) if geom.use_o4(a)]
    if name.startswith("convective"):
        pkg = T if ops is tops else R
        scheme = pkg.ConvectiveScheme(name.split("_")[1])
        return ops.convective(comps, geom, scheme)
    if name == "diffusive_nu":
        return ops.diffusive(comps, 3e-3, geom)
    if name == "diffusive_nu_t":
        return ops.diffusive(comps, 3e-3 + nut, geom)
    if name == "divergence":
        return ops.divergence(comps, geom)
    if name == "pressure_grad_face":
        return [ops.pressure_grad_face(p, a, geom) for a in range(3)]
    if name == "correct_velocity":
        return ops.correct_velocity(comps, p, 1e-2, geom)
    return ops.laplacian(p, geom)


@pytest.mark.parametrize("name", OPERATORS)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_operator_matches_reference(grid, name):
    """Each O4 stencil (on the grid's O4 axes) and each operator that
    takes them, on one NumPy-seeded input, to 1e-12."""
    rg, tg, cfg = _geoms(grid)
    comps, p, nut = _inputs(cfg, seed=len(grid) + len(name))
    want = _operator(name, rops, rg, tuple(jnp.asarray(c) for c in comps),
                     jnp.asarray(p), jnp.asarray(nut))
    got = _operator(name, tops, tg, tuple(_t(c) for c in comps), _t(p),
                    _t(nut))
    _close(got, want, f"{grid} {name}")


def test_o4_changes_what_the_reference_changes():
    """At O4 skew convection and nu_t diffusion are the O2 ones (as in the
    reference), central convection and scalar-nu diffusion are not."""
    _, tg, cfg = _geoms("box16")
    o2 = dataclasses.replace(tg, space_order=2)
    comps, _, nut = _inputs(cfg, seed=3)
    c = tuple(_t(a) for a in comps)
    skew = T.ConvectiveScheme.SKEW
    central = T.ConvectiveScheme.CENTRAL
    _close(tops.convective(c, tg, skew), tops.convective(c, o2, skew),
           "skew", atol=0)
    _close(tops.diffusive(c, 1e-3 + _t(nut), tg),
           tops.diffusive(c, 1e-3 + _t(nut), o2), "nu_t", atol=0)
    for got, o2_got in ((tops.convective(c, tg, central),
                         tops.convective(c, o2, central)),
                        (tops.diffusive(c, 1e-3, tg),
                         tops.diffusive(c, 1e-3, o2))):
        assert all(float((a - b).abs().max()) > 1e-6
                   for a, b in zip(got, o2_got))


# ---------------------------------------------------------------------------
# Poisson
# ---------------------------------------------------------------------------


# grid, transform: the transforms' axis kinds in both packages
POISSON = (
    ("box16", "fft"), ("box16", "matmul"),
    ("channel", "fft"), ("channel", "matmul"),
    ("box_n3_n4", "fft"), ("box_n3_n4", "matmul"),
    ("box_n5", "matmul"),
    # a 32-cell x on the plain four-step Hartley, the others dense
    ("box32x4x8", "fht"),
    # a 64-cell x on the Hartley kernels (their twins here), the others
    # dense: the O4 symbol as the modal pass's operand
    ("box64x4x8", "pallas_fft"),
)
POISSON_GRIDS = {
    "box32x4x8": dict(BOX, Nx=32, Ny=4, Nz=8),
    "box64x4x8": dict(BOX, Nx=64, Ny=4, Nz=8),
}


@pytest.mark.parametrize("grid,transform", POISSON)
def test_fdm_solve_matches_reference(grid, transform):
    """The O4 FDM solve equals the reference's (same axis kinds) to 1e-11
    relative, and the port's O4 Laplacian of it equals the rhs less its
    volume-weighted mean to 1e-10 of its scale."""
    kw = POISSON_GRIDS.get(grid) or GRIDS[grid][0]
    rcfg, tcfg = _cfg(R, **kw).finalize(), _cfg(T, **kw).finalize()
    rmesh, tmesh = RMesh.from_config(rcfg), TMesh.from_config(tcfg)
    tg = TGeometry.make(tmesh, tcfg, device="cpu")
    rs = RFDM(rmesh, rcfg, transform=transform)
    ts = TFDM(tmesh, tcfg, transform=transform, device="cpu")
    assert ts.name == rs.name
    for rt, tt in zip(rs.tr, ts.tr):
        np.testing.assert_allclose(tt.lam, rt.lam, rtol=1e-13, atol=1e-9)
    shape = (tcfg.Nx, tcfg.Ny, tcfg.Nz)
    rhs = np.random.default_rng(len(grid)).standard_normal(shape)
    want = np.asarray(rs.solve(jnp.asarray(rhs)))
    got = ts.solve(_t(rhs))
    err = (np.linalg.norm(got.numpy() - want)
           / max(np.linalg.norm(want), 1e-300))
    assert err <= 1e-11, err
    # the rhs less its null component, the volume-weighted mean (the
    # cell widths of a stretched axis weigh it)
    vol = np.einsum("i,j,k->ijk", tmesh.x.d, tmesh.y.d, tmesh.z.d)
    lap = tops.laplacian(got, tg).numpy()
    mean_free = rhs - np.sum(rhs * vol) / np.sum(vol)
    assert np.max(np.abs(lap - mean_free)) <= 1e-10 * np.max(
        np.abs(mean_free))


def test_o2_only_wrappers_refuse_o4():
    """The kernels the reference runs at O2 only refuse an O4 geometry:
    the padded-x predictor and the two predictor + divergence kernels."""
    _, tg, cfg = _geoms("box16")
    comps, _, _ = _inputs(cfg, seed=1)
    u, v, w = (_t(c) for c in comps)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="O2"):
        K.predictor_periodic_div(u, v, w, dt, geom=tg, nu=1e-3, fx=0.0)
    assert K.nu_sgs_eligible(tg) and K.germano_pass1_eligible(tg)
    _, cg, ccfg = _geoms("channel")
    comps, _, _ = _inputs(ccfg, seed=2)
    with pytest.raises(NotImplementedError, match="O2"):
        K.predictor_channel_div(*(_t(c) for c in comps), dt,
                                K.channel_y_arrays(cg), geom=cg, nu=1e-3,
                                fx=0.0, scheme=T.ConvectiveScheme.CENTRAL)
    wall_x = dict(BOX, Nx=12, Ny=12, Nz=12, bc_x="wall")
    xs = T.Simulation(_cfg(T, **wall_x), device="cpu")
    assert not K.xpad_eligible(xs.geom, xs.cfg)
    comps, _, _ = _inputs(xs.cfg, seed=3)
    xgeom = K.xpad_geometry(xs.geom)
    with pytest.raises(NotImplementedError, match="O2"):
        K.predictor_xpad(*(_t(c) for c in comps), dt,
                         K.general_arrays(xgeom), geom=xs.geom, xgeom=xgeom,
                         nu=1e-3, fx=0.0, scheme=T.ConvectiveScheme.SKEW)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def _ref_plan(rs):
    """The reference's kernel choice as the port names it: the predictor
    branch of its _fused_star_impl (cfdnn_tpu/solver.py:755-827) under its
    tiling mode, the projection kernels of that mode and the closure's
    fused kernel."""
    cfg, mode = rs.cfg, rs._pallas_predictor_ok
    if not mode:
        return KernelPlan(None, None, None)
    all_periodic = all(ax.periodic and ax.uniform for ax in rs.geom.axes)
    laminar = cfg.turb_model == R.TurbulenceModel.NONE
    if mode == "xz":
        predictor = "general_xz"
    elif mode == "xpad":
        predictor = "xpad"
    elif (all_periodic and cfg.space_order == 2 and laminar
          and cfg.convective_scheme == R.ConvectiveScheme.SKEW):
        predictor = "periodic"
    elif rs._channel_slab_ok:
        predictor = "channel"
    else:
        predictor = "general"
    closure = None
    fuse = getattr(rs.turb, "_fuse", False)
    name = type(rs.turb).__name__
    if fuse == "slab":
        closure = ("germano_pass1" if "Dynamic" in name else "nu_sgs")
    elif cfg.turb_model in (R.TurbulenceModel.SST, R.TurbulenceModel.KOMEGA):
        closure = "transport"
    return KernelPlan(predictor, "slab" if mode == "slab" else mode,
                      closure)


# path: (port config, its plan)
PATHS = {
    "tgv_re1600_o4": (bench.tgv_re1600_config(16, "float64", space_order=4),
                      KernelPlan("general", "slab", None)),
    "channel_o4": (bench.channel_config(16, "float64", space_order=4,
                                        Ny=12, benchmark=False),
                   KernelPlan("general", "slab", None)),
    "les_channel_o4": (bench.les_channel_config(16, "float64",
                                                space_order=4,
                                                benchmark=False),
                       KernelPlan("general", "slab", "nu_sgs")),
    "dynamic_box_o4": (bench.les_tgv_config(
        16, "float64", space_order=4, benchmark=False,
        turb_model=T.TurbulenceModel.DYNAMIC_SMAGORINSKY),
        KernelPlan("general", "slab", "germano_pass1")),
    "komega_channel_o4": (bench.rans_channel_config(
        16, "float64", space_order=4, Ny=12, benchmark=False,
        turb_model=T.TurbulenceModel.KOMEGA),
        KernelPlan("general", "slab", "transport")),
    "les_duct_o4": (bench.les_duct_config(16, "float64", space_order=4,
                                          benchmark=False),
                    KernelPlan("general", "slab", "nu_sgs")),
}


@pytest.mark.parametrize("name", sorted(PATHS))
def test_plan_matches_reference(name):
    """The plan a CUDA device would get under "auto" (a plan allocates
    nothing) equals the reference's kernel choice under "on": the general
    predictor with the slab projection, never the periodic or channel
    predictor, and the closure's kernel; the same plan under "on" on the
    CPU, and none under "auto" there."""
    tcfg, plan = PATHS[name]
    rs = R.Simulation(_ref_cfg(tcfg, use_pallas="on"))
    assert _ref_plan(rs) == plan
    sim = T.Simulation(tcfg, device="cpu")
    assert sim.kernels == KernelPlan(None, None)
    sim.device = torch.device("cuda", 0)
    assert sim._select_kernels() == plan
    assert sim._fuse_div_mode() is False
    on = T.Simulation(tcfg.with_(use_pallas="on"), device="cpu")
    assert on.kernels == plan


def test_periodic_predictor_never_at_o4(monkeypatch):
    """The all-periodic skew Taylor-Green takes predictor_periodic at O2
    and predictor_general at O4 (the reference's fused_predictor is O2
    only), with the opt-in fused divergence too (no div kernel at O4)."""
    monkeypatch.setenv("CFDNN_FUSE_DIV", "1")
    for order, plan, fuse in ((2, "periodic", "periodic"),
                              (4, "general", False)):
        cfg = bench.tgv_config(16, "float64", space_order=order)
        sim = T.Simulation(cfg.with_(use_pallas="on"), device="cpu")
        assert K.periodic_eligible(sim.geom)
        assert sim.kernels.predictor == plan and sim._fuse_div == fuse
        rs = R.Simulation(_ref_cfg(cfg, use_pallas="on"))
        assert _ref_plan(rs).predictor == plan


def test_o4_xz_grid_is_refused(monkeypatch):
    """An O4 grid above the slab cap (lowered here, as
    tests/test_torch_xz.py lowers it), which the port refused before it
    had the O4 xz kernels, is no longer refused: its plan is the
    reference's, "xz" with the O4 xz kernels (general_xz, the xz
    projection and nu_sgs_xz for the LES closure) under use_pallas "on"
    and "auto" on the card, and the eager chain under "off" or "auto" on
    the CPU."""
    monkeypatch.setattr(TS, "SLAB_FIT_CELLS", 8)
    cfg = bench.les_tgv_config(16, "float64", Nz=32, space_order=4)
    assert TS.tiling_mode(T.Simulation(cfg, device="cpu").geom, cfg) == "xz"
    plan = KernelPlan("general_xz", "xz", "nu_sgs_xz")
    assert T.Simulation(cfg.with_(use_pallas="on"),
                        device="cpu").kernels == plan
    sim = T.Simulation(cfg, device="cpu")
    assert sim.kernels == KernelPlan(None, None)
    sim.device = torch.device("cuda", 0)
    assert sim._select_kernels() == plan
    off = T.Simulation(cfg.with_(use_pallas="off"), device="cpu")
    assert off.kernels == KernelPlan(None, None)


# ---------------------------------------------------------------------------
# Convergence
# ---------------------------------------------------------------------------


def test_o4_divergence_converges_at_fourth_order():
    """The reference's MMS (tests/test_convergence.py:31) on the port: the
    O4 divergence of an analytic staggered field on periodic N x N grids,
    N = 16, 32, 64, converges at a rate above 3.7 (the O2 one near 2)."""
    rates = {}
    for order in (2, 4):
        errs, ns = [], [16, 32, 64]
        for n in ns:
            cfg = T.Config(Nx=n, Ny=n, Nz=1, y_min=0.0, y_max=2 * np.pi,
                           bc_x=T.BCType.PERIODIC, bc_y=T.BCType.PERIODIC,
                           nu=1e-2, nu_specified=True, dp_dx=0.0,
                           dp_dx_specified=True, dtype="float64",
                           space_order=order)
            mesh = TMesh.from_config(cfg)
            geom = TGeometry.make(mesh, cfg, device="cpu")
            xf, yc = mesh.x.faces[:-1], mesh.y.centers
            xc, yf = mesh.x.centers, mesh.y.faces[:-1]
            u = np.sin(xf)[:, None, None] * np.cos(yc)[None, :, None]
            v = np.cos(xc)[:, None, None] * np.sin(yf)[None, :, None]
            div = tops.divergence((_t(u), _t(v), torch.zeros((n, n, 1),
                                                             dtype=torch.float64)),
                                  geom).numpy()
            exact = 2.0 * np.cos(xc)[:, None, None] * np.cos(yc)[None, :, None]
            errs.append(np.abs(div - exact).max())
        rates[order] = -np.polyfit(np.log(ns), np.log(errs), 1)[0]
    assert rates[4] > 3.7, rates
    assert 1.7 < rates[2] < 2.3, rates
