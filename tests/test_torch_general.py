"""The port's general predictor (predictor_general, predictor_xpad), nu_sgs
on a walled z, their kernel plans and the two LES paths they carry, against
the JAX reference at float64 on the CPU.

Grids at 16^3 and 16x12x12 (the duct), inputs from np.random.default_rng
handed across as NumPy arrays; the reference's Pallas kernels run as its
own tests run them (`fused_*(..., interpret=True)`), the port's wrappers
take their plain twins on CPU tensors. Limits, the reference's own where it
has one: the predictor 1e-13 (tests/test_pallas_kernels.py:674), nu_sgs
1e-14, 5-step trajectories 1e-11 in u, v, w, p and 1e-12 in nu_t.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu_torch import bench
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.solver import KernelPlan

PHYS = dict(nu=3e-3, nu_specified=True, dp_dx=-0.4, dp_dx_specified=True,
            dt=1e-3, adaptive_dt=False, dtype="float64")
WALLS = dict(y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0)
PERIODIC = dict(Nx=16, Ny=16, Nz=16, bc_y="periodic", y_min=0.0,
                y_max=1.0, x_max=1.0, z_max=2.0)
DUCT = dict(WALLS, Nx=16, Ny=12, Nz=12, x_max=4.0, bc_z="wall",
            stretch_y=True, stretch_z=True)
# the six geometry cases: (grid, scheme, with nu_t)
GEOMETRIES = {
    "periodic-skew-nut": (PERIODIC, "skew", True),
    "channel-central-nut": (dict(Nx=16, Ny=12, Nz=8, z_max=1.0,
                                 stretch_y=True), "central", True),
    "duct-skew-nut": (DUCT, "skew", True),
    "duct-central-nut": (DUCT, "central", True),
    "lid-skew": (dict(Nx=16, Ny=12, Nz=8, y_min=0.0, y_max=1.0, x_max=2.0,
                      z_max=1.0, lid_velocity=1.3), "skew", False),
    "periodic-y-walled-z-nut": (dict(WALLS, Nx=16, Ny=12, Nz=12,
                                     bc_y="periodic", y_min=0.0, y_max=1.0,
                                     bc_z="wall", stretch_z=True),
                                "central", True),
}
WALL_X = dict(Nx=12, Ny=12, Nz=12, bc_x="wall", bc_y="periodic", y_min=0.0,
              y_max=1.0, x_max=1.5, z_max=2.0, convective_scheme="skew")
CLOSURES = {"smagorinsky": 0.17, "wale": 0.325, "vreman": 0.07}


def _cfg(pkg, **kw):
    k = dict(PHYS, **kw)
    for name, enum_ in (("bc_x", pkg.BCType), ("bc_y", pkg.BCType),
                        ("bc_z", pkg.BCType),
                        ("convective_scheme", pkg.ConvectiveScheme),
                        ("turb_model", pkg.TurbulenceModel)):
        if name in k:
            k[name] = enum_(k[name])
    return pkg.Config(**k)


def _sims(**kw):
    return R.Simulation(_cfg(R, **kw)), T.Simulation(_cfg(T, **kw),
                                                      device="cpu")


def _inputs(sim, seed, with_nut):
    rng = np.random.default_rng(seed)
    comps = [rng.standard_normal(s) for s in T.velocity_shapes(sim.cfg)]
    cells = (sim.cfg.Nx, sim.cfg.Ny, sim.cfg.Nz)
    nut = 1e-2 * np.abs(rng.standard_normal(cells)) if with_nut else None
    return comps, nut


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, atol, what=""):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=atol, err_msg=what)


@pytest.mark.parametrize("case", sorted(GEOMETRIES))
def test_predictor_general_matches_pallas(case):
    """predictor_general_twin and the predictor_general wrapper (its twin
    on the CPU) against the reference's fused_predictor_general in
    interpret mode, to 1e-13, on each geometry the kernel serves."""
    grid, scheme, with_nut = GEOMETRIES[case]
    rs, ts = _sims(**grid, convective_scheme=scheme)
    assert K.general_eligible(ts.geom, ts.cfg)
    comps, nut = _inputs(ts, 1, with_nut)
    dt, fx = 1e-2, 0.7
    want = PK.fused_predictor_general(
        *(jnp.asarray(c) for c in comps), dt, geom=rs.geom,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=fx,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    u, v, w = (_t(c) for c in comps)
    dt_t = torch.tensor(dt, dtype=torch.float64)
    kw = dict(geom=ts.geom, nu=ts.cfg.nu, fx=fx,
              scheme=ts.cfg.convective_scheme)
    _close(K.predictor_general_twin(u, v, w, dt_t, _t(nut), **kw), want,
           1e-13, "twin")
    _close(K.predictor_general(u, v, w, dt_t, K.general_arrays(ts.geom),
                               nu_t=_t(nut), **kw), want, 1e-13, "wrapper")


@pytest.mark.parametrize("with_nut", [False, True])
def test_predictor_xpad_matches_pallas(with_nut):
    """predictor_xpad (the wrapper around predictor_general on the padded
    axis) and its twin against the reference's fused_predictor_xpad on a
    no-slip x, every output, to 1e-13."""
    rs, ts = _sims(**WALL_X)
    assert K.xpad_eligible(ts.geom, ts.cfg)
    assert not K.general_eligible(ts.geom, ts.cfg)
    comps, nut = _inputs(ts, 3, with_nut)
    dt, fx = 1e-3, 0.4
    want = PK.fused_predictor_xpad(
        *(jnp.asarray(c) for c in comps), dt, geom=rs.geom,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=fx,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    u, v, w = (_t(c) for c in comps)
    dt_t = torch.tensor(dt, dtype=torch.float64)
    xg = K.xpad_geometry(ts.geom)
    kw = dict(geom=ts.geom, xgeom=xg, nu=ts.cfg.nu, fx=fx,
              scheme=ts.cfg.convective_scheme)
    _close(K.predictor_xpad_twin(u, v, w, dt_t, _t(nut), **kw), want, 1e-13,
           "twin")
    _close(K.predictor_xpad(u, v, w, dt_t, K.general_arrays(xg),
                            nu_t=_t(nut), **kw), want, 1e-13, "wrapper")


@pytest.mark.parametrize("closure", sorted(CLOSURES))
def test_nu_sgs_on_the_duct_matches_pallas(closure):
    """nu_sgs on the stretched walled-y/z duct (twin and wrapper) against
    the reference's fused_nu_sgs in interpret mode, to 1e-14 (both LES
    kernels' gates take the duct)."""
    rs, ts = _sims(**DUCT, turb_model=closure, use_pallas="on")
    assert K.nu_sgs_eligible(ts.geom) and K.germano_pass1_eligible(ts.geom)
    comps, _ = _inputs(ts, 5, False)
    want = PK.fused_nu_sgs(*(jnp.asarray(c) for c in comps), geom=rs.geom,
                           model_fn=rs.turb._model_fn, interpret=True)
    kw = dict(geom=ts.geom, closure=closure, coeff=CLOSURES[closure])
    u, v, w = (_t(c) for c in comps)
    _close(K.nu_sgs_twin(u, v, w, **kw), want, 1e-14, "twin")
    _close(K.nu_sgs(u, v, w, K.les_arrays(ts.geom), **kw), want, 1e-14,
           "wrapper")


@pytest.mark.parametrize("closure", sorted(CLOSURES))
def test_nu_sgs_twin_repeats_itself_on_the_duct(closure):
    """nu_sgs_twin called four times on the same duct inputs in one process
    gives the same bits each time (torch's CPU vector math is set up on one
    thread at import, utils/numerics.py, so no call races it)."""
    _, ts = _sims(**DUCT, turb_model=closure, use_pallas="on")
    u, v, w = (_t(c) for c in _inputs(ts, 5, False)[0])
    kw = dict(geom=ts.geom, closure=closure, coeff=CLOSURES[closure])
    first = K.nu_sgs_twin(u, v, w, **kw)
    for _ in range(3):
        assert torch.equal(K.nu_sgs_twin(u, v, w, **kw), first)


LES_TGV = dict(Nx=16, Ny=16, Nz=16, bc_x="periodic", bc_y="periodic",
               bc_z="periodic", y_min=0.0, y_max=2 * np.pi, z_max=2 * np.pi,
               nu=1.0 / 1600.0, dp_dx=0.0, convective_scheme="skew",
               turb_model="smagorinsky")
LES_DUCT = dict(DUCT, nu=1e-4, dp_dx=-1e-3, dt=2e-4, turb_model="wale")
PLANS = {
    "les_tgv": (LES_TGV, KernelPlan("general", "slab", "nu_sgs")),
    "les_duct": (LES_DUCT, KernelPlan("general", "slab", "nu_sgs")),
    "lid_channel": (dict(GEOMETRIES["lid-skew"][0]),
                    KernelPlan("general", "slab", None)),
    "wall_x": (WALL_X, KernelPlan("xpad", None, None)),
    "dynamic_duct": (dict(LES_DUCT, turb_model="dynamic_smagorinsky"),
                     KernelPlan("general", "slab", "germano_pass1")),
    # with the slab cap lowered (solver.SLAB_FIT_CELLS), as the reference's
    # tests/test_pallas_kernels.py:265 lowers its own
    "les_tgv_xz": (dict(LES_TGV, Nz=32),
                   KernelPlan("general_xz", "xz", "nu_sgs_xz")),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_cuda_kernel_plans(name, monkeypatch):
    """The plan a CUDA device would get under "auto" (a plan allocates
    nothing): the general predictor for the LES Taylor-Green, the duct and
    the lid channel, xpad with the eager projection for a no-slip x,
    germano_pass1 for the dynamic model on a walled z, and the
    (x, z)-tiled kernels for the LES Taylor-Green on a plane above the
    slab cap."""
    grid, plan = PLANS[name]
    if name.endswith("_xz"):
        monkeypatch.setattr(T.solver, "SLAB_FIT_CELLS", 8)
    sim = T.Simulation(_cfg(T, **grid), device="cpu")
    assert sim.kernels == KernelPlan(None, None)
    sim.device = torch.device("cuda", 0)
    assert sim._select_kernels() == plan


@pytest.mark.parametrize("name", ["les_tgv", "les_duct"])
def test_les_trajectory_matches_reference(name):
    """5 steps of the port under use_pallas="on" (through its wrappers'
    twins) against the reference's step from the same initial state: u, v,
    w, p to 1e-11, nu_t to 1e-12. The reference runs its operator chain
    ("off"): its interpret-mode kernels cost ~8 s here, and the tests above
    hold them to the port's twins."""
    grid = PLANS[name][0]
    rs = R.Simulation(_cfg(R, **grid, use_pallas="off"))
    ts = T.Simulation(_cfg(T, **grid, use_pallas="on"), device="cpu")
    assert ts.kernels == KernelPlan("general", "slab", "nu_sgs")
    if name == "les_tgv":
        r = R.init_taylor_green(rs.cfg, rs.mesh)
    else:
        r = R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05)
    keys = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "nu_t")
    t = T.state_from_numpy({k: np.asarray(getattr(r, k)) for k in keys
                            if getattr(r, k) is not None}, "cpu",
                           torch.float64)
    for _ in range(5):
        r, _ = rs.step(r)
        t, td = ts.step(t)
    out = T.state_to_numpy(t)
    for k in ("u", "v", "w", "p"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(r, k)), rtol=0,
                                   atol=1e-11, err_msg=k)
    np.testing.assert_allclose(out["nu_t"], np.asarray(r.nu_t), rtol=0,
                               atol=1e-12, err_msg="nu_t")
    assert float(np.max(out["nu_t"])) > 0.0
    assert float(td.div_linf) < 1e-10


def test_general_wrapper_gradients_match_twin():
    """The autograd bridge of predictor_general and predictor_xpad:
    gradients through the wrappers (u, v, w, dt and nu_t) equal those of
    autograd through the twins."""
    for grid in (DUCT, WALL_X):
        _, ts = _sims(**dict(grid, convective_scheme="central"))
        comps, nut = _inputs(ts, 7, True)
        base = [_t(c) for c in comps] + [_t(nut),
                                         torch.tensor(1e-2,
                                                      dtype=torch.float64)]
        g = ts.geom
        kw = dict(nu=ts.cfg.nu, fx=0.3, scheme=ts.cfg.convective_scheme)
        if grid is WALL_X:
            xg = K.xpad_geometry(g)
            kw.update(geom=g, xgeom=xg)
            fns = (lambda u, v, w, n, dt: K.predictor_xpad(
                       u, v, w, dt, K.general_arrays(xg), nu_t=n, **kw),
                   lambda u, v, w, n, dt: K.predictor_xpad_twin(
                       u, v, w, dt, n, **kw))
        else:
            kw.update(geom=g)
            fns = (lambda u, v, w, n, dt: K.predictor_general(
                       u, v, w, dt, K.general_arrays(g), nu_t=n, **kw),
                   lambda u, v, w, n, dt: K.predictor_general_twin(
                       u, v, w, dt, n, **kw))
        grads = []
        for fn in fns:
            xs = [a.clone().requires_grad_() for a in base]
            su, sv, sw = fn(*xs)
            (su.square().sum() + (sv * sv.flip(0)).sum()
             + sw.sin().sum()).backward()
            grads.append([x.grad for x in xs])
        for a, b in zip(*grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)


def test_general_wrappers_refuse_what_they_do_not_serve():
    """The wrappers raise on a grid or scheme outside the kernel: a 2-D
    grid, upwind2 handed to xpad (its stencil reaches past the pad's one
    ghost plane, as the reference's xpad gate has it), and a periodic x
    handed to xpad."""
    _, flat = _sims(**dict(PERIODIC, Nz=1))
    assert not K.general_eligible(flat.geom, flat.cfg)
    comps, _ = _inputs(flat, 8, False)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    kw = dict(nu=1e-3, fx=0.0, scheme=T.ConvectiveScheme.SKEW)
    with pytest.raises(NotImplementedError, match="predictor_general"):
        K.predictor_general(*(_t(c) for c in comps), dt, (),
                            geom=flat.geom, **kw)
    _, ts = _sims(**PERIODIC)
    u, v, w = (_t(c) for c in _inputs(ts, 8, False)[0])
    _, wx = _sims(**WALL_X)
    xg = K.xpad_geometry(wx.geom)
    with pytest.raises(NotImplementedError, match="upwind2"):
        K.predictor_xpad(*(_t(c) for c in _inputs(wx, 8, False)[0]), dt,
                         K.general_arrays(xg), geom=wx.geom, xgeom=xg,
                         nu=1e-3, fx=0.0, scheme=T.ConvectiveScheme.UPWIND2)
    with pytest.raises(NotImplementedError, match="inflow/outflow or "
                       "outflow x"):
        K.predictor_xpad(u, v, w, dt, (), geom=ts.geom, xgeom=ts.geom, **kw)


def test_les_bench_configs():
    """bench.les_tgv_config is bench_tgv's row (bench.py:57-69) with static
    Smagorinsky; bench.les_duct_config is the duct of apps/duct.py at
    128x96x96 with both walls stretched and bench_les_channel's physics
    (bench.py:98-103), WALE. A few CPU steps of each at 16 wide run
    through their closure and stay finite and solenoidal."""
    tgv = bench.les_tgv_config().finalize()
    assert dataclasses.replace(
        tgv, turb_model=T.TurbulenceModel.NONE) == bench.tgv_config().finalize()
    assert tgv.turb_model == T.TurbulenceModel.SMAGORINSKY
    duct = bench.les_duct_config().finalize()
    assert (duct.Nx, duct.Ny, duct.Nz) == (128, 96, 96)
    assert (duct.x_min, duct.x_max, duct.y_min, duct.y_max, duct.z_min,
            duct.z_max) == (0.0, 4.0, -1.0, 1.0, -1.0, 1.0)
    assert (duct.bc_x, duct.bc_y, duct.bc_z) == (
        T.BCType.PERIODIC, T.BCType.WALL, T.BCType.WALL)
    assert duct.stretch_y and duct.stretch_z
    assert duct.stretch_beta == duct.stretch_beta_z == 2.0
    assert (duct.nu, duct.dp_dx, duct.dt, duct.dtype) == (1e-4, -1e-3, 2e-4,
                                                          "float32")
    assert duct.turb_model == T.TurbulenceModel.WALE and duct.benchmark
    assert duct.convective_scheme == T.ConvectiveScheme.CENTRAL
    for case in (bench.les_tgv_case, bench.les_duct_case):
        sim, st = case(16, device="cpu", dtype="float64")
        st, d = sim.run(st, 3)
        assert bool(torch.isfinite(st.nu_t).all()) and float(st.nu_t.max()) > 0
        assert float(d.div_linf) < 1e-10
