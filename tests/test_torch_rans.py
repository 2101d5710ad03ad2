"""The port's RANS slice (turbulence/transport.py, earsm.py, algebraic.py,
the wall helpers of base.py, the transport kernel's twin and dispatch, the
k/omega state) against the JAX reference at float64 on the CPU.

Grids: the stretched 16x24x8 channel of tests/test_pallas_kernels.py:754,
a stretched 16x12x12 duct (walls in y and z) and an all-periodic 16^3 box.
Inputs come from np.random.default_rng(seed), or from the reference's
perturbed_channel and initialize, and cross as NumPy arrays. The
reference's fused_transport_advance runs as its own tests run it
(interpret=True); the port's kernel wrapper takes its plain twin on CPU
tensors. Limits: the transport math and the wrapper rtol 1e-12 and atol
1e-13 (the reference's own, tests/test_pallas_kernels.py:786-788); the
wall helpers 1e-14; each closure's nu_t 1e-12 of its scale; 5-step
trajectories 1e-12 of each field's scale (omega reaches ~1e3 at the first
cell).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu.turbulence import base as rbase
from cfdnn_tpu.turbulence import transport as rtr
from cfdnn_tpu_torch import bench
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.solver import KernelPlan
from cfdnn_tpu_torch.turbulence import base as tbase
from cfdnn_tpu_torch.turbulence import transport as ttr

GRIDS = {
    "channel": dict(Nx=16, Ny=24, Nz=8, stretch_y=True, z_max=1.0),
    "duct": dict(Nx=16, Ny=12, Nz=12, stretch_y=True, stretch_z=True,
                 bc_z="wall", y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0),
    "periodic": dict(Nx=16, Ny=16, Nz=16, bc_y="periodic", bc_z="periodic",
                     y_min=0.0, y_max=2 * np.pi, z_max=2 * np.pi,
                     convective_scheme="skew"),
}
PHYS = dict(nu=1e-3, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
            dt=1e-3, adaptive_dt=False, dtype="float64")
RTOL, ATOL = 1e-12, 1e-13
CLOSURES = ("sst", "komega", "earsm_wj", "earsm_gs", "earsm_pope",
            "baseline", "gep")
KEYS = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "k", "omega",
        "nu_t")


def _cfg(pkg, **kw):
    k = dict(PHYS, **kw)
    for name in ("bc_x", "bc_y", "bc_z"):
        if name in k:
            k[name] = pkg.BCType(k[name])
    for name, enum_ in (("turb_model", pkg.TurbulenceModel),
                        ("convective_scheme", pkg.ConvectiveScheme)):
        if name in k:
            k[name] = enum_(k[name])
    return pkg.Config(**k)


def _sims(grid="channel", **kw):
    kw = dict(GRIDS[grid] if isinstance(grid, str) else grid, **kw)
    return R.Simulation(_cfg(R, **kw)), T.Simulation(_cfg(T, **kw),
                                                      device="cpu")


def _fields(sim, seed):
    """Velocity ~ N(0, 1) and k > 0, omega > 0, nu_t >= 0 at the cells."""
    rng = np.random.default_rng(seed)
    vel = [rng.standard_normal(s) for s in T.velocity_shapes(sim.cfg)]
    cell = (sim.cfg.Nx, sim.cfg.Ny, sim.cfg.Nz)
    k = np.abs(rng.standard_normal(cell)) * 1e-2 + 1e-4
    om = np.abs(rng.standard_normal(cell)) * 10.0 + 1.0
    nut = np.abs(rng.standard_normal(cell)) * 1e-3
    return vel, k, om, nut


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _to_port(state):
    return T.state_from_numpy(
        {k: np.asarray(getattr(state, k)) for k in KEYS
         if getattr(state, k) is not None}, "cpu", torch.float64)


@pytest.mark.parametrize("math", ["sst", "komega", "sst_nut"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_transport_math_matches_reference(grid, math):
    """sst_advance_math / komega_advance_math (k_new, om_new, nu_k, nu_om)
    and sst_nut_math equal the reference's on each grid, from the same
    random fields and the same wall distance and omega wall value."""
    model = "komega" if math == "komega" else "sst"
    rs, ts = _sims(grid, turb_model=model)
    vel, k, om, nut = _fields(ts, 1)
    rt, tt = rs.turb, ts.turb
    om_wall = tt.om_wall
    if math == "sst_nut":
        sr_r = rbase.strain_rotation(_j(vel), rs.geom)
        sr_t = tbase.strain_rotation(_t(vel), ts.geom)
        want = rtr.sst_nut_math(jnp.asarray(k), jnp.asarray(om), sr_r.S_mag,
                                rt.y_wall, rs.cfg.nu, rt.c)
        got = ttr.sst_nut_math(*_t([k, om]), sr_t.S_mag, tt.y_wall,
                               ts.cfg.nu, tt.c)
        _close(got, want, what="nu_t")
        return
    rmath, tmath = ((rtr.komega_advance_math, ttr.komega_advance_math)
                    if math == "komega" else
                    (rtr.sst_advance_math, ttr.sst_advance_math))
    want = rmath(_j(vel), *_j([k, om, nut]), rs.geom, rs.cfg.nu, rt.c,
                 rt.y_wall, om_wall, 1e-3)
    got = tmath(_t(vel), *_t([k, om, nut]), ts.geom, ts.cfg.nu, tt.c,
                tt.y_wall, om_wall, 1e-3)
    for name, g, w in zip(("k_new", "om_new", "nu_k", "nu_om"), got, want):
        _close(g, w, what=name)


@pytest.mark.parametrize("model", sorted(K.TRANSPORT_MODELS))
def test_transport_wrapper_matches_pallas(model):
    """The transport wrapper (its twin on the CPU) against the reference's
    fused_transport_advance in interpret mode on the stretched channel,
    each instantiation with the model's own constants (the pin mask and
    om_visc of the SST closure's third output included)."""
    kind = "komega" if model == "komega" else "sst"
    rs, ts = _sims(turb_model=kind)
    vel, k, om, nut = _fields(ts, 2)
    rt, tt = rs.turb, ts.turb
    om_wall = tt.om_wall
    if model == "komega":
        form, n_out, ng = rtr._komega_math_kernel_form, 2, 1
        consts, extra = [rt.y_wall], dict(skip_y=False)
    elif model == "sst":
        form, n_out, ng = rtr._sst_math_kernel_form, 2, 2
        consts, extra = [rt.y_wall], dict(skip_y=False)
    else:
        form, n_out, ng = rtr._sst_math_with_nut_kernel_form, 3, 2
        consts = [rt.y_wall, rt.om_pin_mask.astype(jnp.float64), rt.om_visc]
        extra = dict(has_wall=True)
    math_fn = functools.partial(form, nu=rs.cfg.nu, c=rt.c, om_wall=om_wall,
                                **extra)
    want = PK.fused_transport_advance(
        *_j(vel), *_j([k, om, nut]), 1e-3, geom=rs.geom, math_fn=math_fn,
        consts=consts, n_out=n_out, ng=ng, interpret=True)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    got = K.transport(*_t(vel), *_t([k, om, nut]), dt, tt.kernel_consts,
                      K.transport_arrays(ts.geom), geom=ts.geom, model=model,
                      c=tt.c, nu=ts.cfg.nu, om_wall=om_wall)
    assert len(got) == n_out
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, what=f"output {i}")


@pytest.mark.parametrize("grid", sorted(GRIDS) + ["lid"])
def test_wall_helpers_match_reference(grid):
    """wall_distance (min over the y and z walls; the half-height without
    one), u_tau_wall (relative to a moving lid's own velocity) and
    k_omega_channel_estimate equal the reference's."""
    g = (dict(GRIDS["channel"], lid_velocity=0.7) if grid == "lid"
         else GRIDS[grid])
    rs, ts = _sims(g)
    want_y = rbase.wall_distance(rs.mesh, rs.cfg, jnp.float64)
    got_y = tbase.wall_distance(ts.mesh, ts.cfg, torch.float64, device="cpu")
    assert tuple(got_y.shape) == tuple(want_y.shape)
    _close(got_y, want_y, 0.0, 0.0, "wall distance")
    vel = _fields(ts, 3)[0]
    vel[0] = vel[0] + 1.0   # a mean flow, so the wall shear is not ~0
    _close(tbase.u_tau_wall(_t(vel), ts.geom, ts.cfg.nu),
           rbase.u_tau_wall(_j(vel), rs.geom, rs.cfg.nu), 1e-14, 0.0,
           "u_tau")
    for got, want in zip(
            tbase.k_omega_channel_estimate(_t(vel), ts.geom, got_y,
                                           ts.cfg.nu),
            rbase.k_omega_channel_estimate(_j(vel), rs.geom, want_y,
                                           rs.cfg.nu)):
        assert got.is_contiguous() and tuple(got.shape) == want.shape
        _close(got, want, 1e-14, 0.0, "k/omega estimate")


def test_lid_shear_is_relative_to_the_lid():
    """A lid moving with the flow next to it reports no phantom shear:
    u_tau comes from the stationary wall alone."""
    _, ts = _sims(dict(GRIDS["channel"], lid_velocity=1.0))
    u = torch.ones(ts.cfg.Nx, ts.cfg.Ny, ts.cfg.Nz, dtype=torch.float64)
    y = ts.geom.y
    d_lo = float(y.centers.reshape(-1)[0] - y.faces.reshape(-1)[0])
    want = np.sqrt(ts.cfg.nu * 0.5 * (1.0 / d_lo))
    assert abs(float(tbase.u_tau_wall((u, None, None), ts.geom, ts.cfg.nu))
               - want) <= 1e-14


@pytest.mark.parametrize("model", CLOSURES)
def test_closure_nu_t_matches_reference(model):
    """Each RANS, EARSM and algebraic closure's nu_t on a random channel
    state (the reference's perturbed_channel velocity, random k > 0,
    omega > 0, nu_t >= 0) equals the reference's to 1e-12 of its scale."""
    rs, ts = _sims(turb_model=model)
    state = R.perturbed_channel(rs.cfg, rs.mesh, amp=0.1)
    _, k, om, nut = _fields(ts, 4)
    state = state.replace(k=jnp.asarray(k), omega=jnp.asarray(om),
                          nu_t=jnp.asarray(nut))
    want = np.asarray(rs.turb.nu_t(state, rs))
    got = ts.turb.nu_t(_to_port(state), ts).numpy()
    scale = float(np.max(np.abs(want)))
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    assert ts.turb.kernel == ("transport" if model not in (
        "baseline", "gep") else None)


@pytest.mark.parametrize("model", ["sst", "komega", "earsm_wj"])
def test_rans_trajectory_matches_reference(model):
    """5 steps of the stretched RANS channel from the reference's
    initialize(perturbed_channel): the port with use_pallas="on" (the
    transport kernel's twin, the channel predictor's, divergence's,
    correct's) against the reference's operator path ("off"). u, v, w, p,
    k, omega and nu_t to 1e-12 of each field's scale."""
    rs = R.Simulation(_cfg(R, **GRIDS["channel"], turb_model=model,
                           use_pallas="off"))
    ts = T.Simulation(_cfg(T, **GRIDS["channel"], turb_model=model,
                           use_pallas="on"), device="cpu")
    assert ts.kernels == KernelPlan("channel", "slab", "transport")
    r = rs.initialize(R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05))
    t = _to_port(r)
    for _ in range(5):
        r, _ = rs.step(r)
        t, td = ts.step(t)
    out = T.state_to_numpy(t)
    for key in ("u", "v", "w", "p", "k", "omega", "nu_t"):
        want = np.asarray(getattr(r, key))
        scale = max(float(np.max(np.abs(want))), 1e-300)
        np.testing.assert_allclose(out[key], want, rtol=0,
                                   atol=1e-12 * scale, err_msg=key)
    assert float(td.div_linf) < 1e-10
    assert float(np.min(out["k"])) > 0 and float(np.min(out["omega"])) > 0


def test_initialize_matches_reference():
    """Simulation.initialize sets k and omega to the closure's channel
    estimate, as the reference's does; a laminar run's initialize is the
    identity."""
    rs, ts = _sims(turb_model="sst")
    r0 = R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05)
    want = rs.initialize(r0)
    got = ts.initialize(_to_port(r0))
    for key in ("k", "omega"):
        _close(getattr(got, key), getattr(want, key), 1e-14, 0.0, key)
    _, lam = _sims()
    st = lam.initial_state()
    assert lam.initialize(st) is st


def _cuda_plan(grid, **kw):
    """The plan a CUDA device would get under "auto" (a plan allocates
    nothing)."""
    _, ts = _sims(grid, **kw)
    ts.device = torch.device("cuda", 0)
    return ts._select_kernels()


def test_rans_kernel_plans():
    """The RANS channel plans the channel predictor and the transport
    kernel, an all-periodic SST run the general one; the EARSM and Wilcox
    closures take the kernel too, the algebraic closures none."""
    for model in ("sst", "komega", "earsm_wj", "earsm_gs", "earsm_pope"):
        assert _cuda_plan("channel", turb_model=model) == KernelPlan(
            "channel", "slab", "transport"), model
    assert _cuda_plan("periodic", turb_model="sst") == KernelPlan(
        "general", "slab", "transport")
    assert _cuda_plan("duct", turb_model="sst") == KernelPlan(
        "general", "slab", "transport")
    for model in ("baseline", "gep"):
        assert _cuda_plan("channel", turb_model=model) == KernelPlan(
            "channel", "slab", None)
    _, on = _sims("periodic", turb_model="sst", use_pallas="on")
    assert on.kernels == KernelPlan("general", "slab", "transport")
    assert on.transport_arrays is not None and on.les_arrays is None


@pytest.mark.parametrize("grid", ["2d", "lid", "xpad"])
def test_transport_gate_refuses(grid):
    """No transport kernel on a 2-D grid, a moving lid (the strain's wall
    ghosts are stationary) or a wall x (the xpad predictor: the
    reference fuses only in its slab mode): "auto" runs the plain math.
    "on" raises on the 2-D grid (no predictor kernel) and on the lid
    (the reference would fuse its transport there), and runs the plain
    math on the wall x, as the reference's "on", whose transport gate
    never fuses outside its slab mode."""
    g = {"2d": dict(GRIDS["channel"], Nz=1),
         "lid": dict(GRIDS["channel"], lid_velocity=0.5),
         "xpad": dict(Nx=12, Ny=12, Nz=12, bc_x="wall", x_max=1.5,
                      z_max=2.0)}[grid]
    assert _cuda_plan(g, turb_model="sst").closure is None
    if grid == "xpad":
        _, on = _sims(g, turb_model="sst", use_pallas="on")
        assert on.kernels == KernelPlan("xpad", None, None)
    else:
        with pytest.raises(NotImplementedError):
            _sims(g, turb_model="sst", use_pallas="on")
    if grid == "lid":
        _, ts = _sims(g, turb_model="sst")
        assert not K.nu_sgs_eligible(ts.geom)
        vel, k, om, nut = _fields(ts, 5)
        with pytest.raises(NotImplementedError, match="B.4"):
            K.transport(*_t(vel), *_t([k, om, nut]),
                        torch.tensor(1e-3, dtype=torch.float64),
                        ts.turb.kernel_consts, K.transport_arrays(ts.geom),
                        geom=ts.geom, model="sst", c=ts.turb.c,
                        nu=ts.cfg.nu, om_wall=ts.turb.om_wall)


def test_transport_wrapper_checks_and_gradient():
    """The wrapper refuses an unknown instantiation and a wrong constant
    shape; gradients through it equal autograd through the twin."""
    _, ts = _sims(turb_model="sst")
    vel, k, om, nut = _fields(ts, 6)
    tt, gs = ts.turb, K.transport_arrays(ts.geom)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    kw = dict(geom=ts.geom, c=tt.c, nu=ts.cfg.nu, om_wall=tt.om_wall)
    base = _t(vel) + _t([k, om, nut])
    with pytest.raises(ValueError, match="model"):
        K.transport(*base, dt, tt.kernel_consts, gs, model="sa", **kw)
    with pytest.raises(ValueError, match="shape"):
        K.transport(*base, dt, (tt.y_wall,), gs, model="sst", **kw)

    def grads(fn):
        xs = [a.clone().requires_grad_() for a in base]
        k_new, om_new, nu_t = fn(*xs)
        (k_new.square().sum() + om_new.sum() + nu_t.sum()).backward()
        return [x.grad for x in xs]

    got = grads(lambda *xs: K.transport(*xs, dt, tt.kernel_consts, gs,
                                        model="sst_nut", **kw))
    want = grads(lambda *xs: K.transport_twin(*xs, dt, *tt.kernel_consts,
                                              model="sst_nut", **kw))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_state_round_trip_carries_k_omega():
    """state_from_numpy / state_to_numpy carry k and omega both ways; the
    transport family's zero state holds them (1e-4 and 1.0, as the
    reference's), an LES state does not."""
    rs, ts = _sims(turb_model="sst")
    st = ts.initial_state()
    assert float(st.k.max()) == float(st.k.min()) == 1e-4
    assert float(st.omega.max()) == float(st.omega.min()) == 1.0
    want = R.zero_state(rs.cfg)
    for key in ("k", "omega", "nu_t"):
        np.testing.assert_array_equal(getattr(st, key).numpy(),
                                      np.asarray(getattr(want, key)))
    rng = np.random.default_rng(7)
    st = st.replace(k=torch.from_numpy(rng.random(st.k.shape)),
                    omega=torch.from_numpy(rng.random(st.k.shape)))
    back = T.state_from_numpy(T.state_to_numpy(st), "cpu", torch.float64)
    assert torch.equal(back.k, st.k) and torch.equal(back.omega, st.omega)
    _, les = _sims(turb_model="wale")
    assert les.initial_state().k is None
    assert "k" not in T.state_to_numpy(les.initial_state())
    with pytest.raises(NotImplementedError, match="A.14"):
        T.state_from_numpy({"u": np.zeros(3), "inlet_u": np.zeros(3)}, "cpu",
                           torch.float64)


def test_rans_channel_bench_config():
    """bench.rans_channel_config is bench_channel with turb_model=sst
    (scripts/measure_upwind.py:58-68); rans_channel_case starts from the
    closure's k/omega estimate, and a few CPU steps stay finite,
    solenoidal and positive in k and omega."""
    cfg = bench.rans_channel_config().finalize()
    assert (cfg.Nx, cfg.Ny, cfg.Nz) == (128, 128, 128) and cfg.stretch_y
    assert (cfg.nu, cfg.dp_dx, cfg.dt, cfg.dtype) == (1e-4, -1e-3, 2e-4,
                                                      "float32")
    assert cfg.turb_model == T.TurbulenceModel.SST and cfg.benchmark
    assert bench.rans_channel_config(16, Ny=12).Ny == 12
    sim, st = bench.rans_channel_case(16, device="cpu", dtype="float64")
    assert float(st.k.max()) > 1e-4   # the estimate, not the zero state's
    st, d = sim.run(st, 3)
    for f in (st.k, st.omega, st.nu_t):
        assert bool(torch.isfinite(f).all())
    assert float(st.k.min()) > 0 and float(st.omega.min()) > 0
    assert float(st.nu_t.max()) > 0 and float(d.div_linf) < 1e-10


@pytest.mark.cuda
def test_transport_kernel_matches_twin_on_cuda():
    """The transport kernel against its twin on the card, float64 on each
    of chip_smoke's grids to 1e-12 of each output's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    for case in chip_smoke._transport_cases(16, torch.float64, dev, 0):
        got, ref = case.kern(), case.twin()
        for out, err, lim, _ in chip_smoke.compare(case.name, got, ref,
                                                   torch.float64):
            assert err <= lim, f"{case.label} {out}: {err} > {lim}"
