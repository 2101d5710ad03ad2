"""The port's LES slice (turbulence/, the cell-nu diffusive, the nu_sgs and
germano_pass1 twins, the LES step) against the JAX reference at float64 on
the CPU.

Grids: the stretched-wall 16x12x8 channel of tests/test_pallas_kernels.py
and the same grid with uniform y. Inputs come from
np.random.default_rng(seed), or from the reference's perturbed_channel,
and cross as NumPy arrays. The reference's Pallas kernels run as its own
tests run them (interpret=True); the port's kernel wrappers take their
plain twins on CPU tensors. Limits, each the reference's own where it has
one: operators and twins 1e-13..1e-14 absolute; closure nu_t 1e-14
absolute (Sigma rtol 1e-5, its arccos amplifies roundoff near degenerate
singular values; dynamic rtol 1e-12, the plane sums reassociate);
trajectories 1e-11 in u, v, w, p and 1e-12 in nu_t.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import operators as rops
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu.turbulence import base as rbase
from cfdnn_tpu_torch import bench
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.ops import operators as tops
from cfdnn_tpu_torch.solver import KernelPlan
from cfdnn_tpu_torch.turbulence import base as tbase

GRIDS = {
    "stretched": dict(Nx=16, Ny=12, Nz=8, z_max=1.0, stretch_y=True),
    "uniform": dict(Nx=16, Ny=12, Nz=8, z_max=1.0),
}
PHYS = dict(nu=1e-3, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
            dt=1e-3, adaptive_dt=False, dtype="float64")
CLOSURES = {"smagorinsky": 0.17, "wale": 0.325, "vreman": 0.07}


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


def _sims(grid="stretched", **kw):
    kw = dict(GRIDS[grid] if isinstance(grid, str) else grid, **kw)
    return R.Simulation(_cfg(R, **kw)), T.Simulation(_cfg(T, **kw),
                                                      device="cpu")


def _velocity(sim, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in T.velocity_shapes(sim.cfg)]


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got.detach()) if torch.is_tensor(got)
                               else np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


def _to_port(state, sim):
    keys = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "nu_t")
    return T.state_from_numpy(
        {k: np.asarray(getattr(state, k)) for k in keys
         if getattr(state, k) is not None}, "cpu", sim.dtype)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_strain_algebra_matches_reference(grid):
    """velocity_gradient, strain_rotation, cell_center_velocity and
    filter_width equal the reference's to 1e-13."""
    rs, ts = _sims(grid)
    arrs = _velocity(ts, 0)
    rc, tc = _j(arrs), _t(arrs)
    rG = rops.velocity_gradient(rc, rs.geom)
    tG = tops.velocity_gradient(tc, ts.geom)
    for a in range(3):
        for b in range(3):
            _close(tG[a][b], rG[a][b], 1e-13, what=f"G[{a}][{b}]")
    rsr = rbase.strain_rotation(rc, rs.geom)
    tsr = tbase.strain_rotation(tc, ts.geom)
    for name in ("S_mag", "O_mag", "O12", "O13", "O23"):
        _close(getattr(tsr, name), getattr(rsr, name), 1e-13, what=name)
    for a in range(3):
        for b in range(3):
            _close(tsr.S[a][b], rsr.S[a][b], 1e-13, what=f"S[{a}][{b}]")
    for t_c, r_c in zip(tbase.cell_center_velocity(tc, ts.geom),
                        rbase.cell_center_velocity(rc, rs.geom)):
        _close(t_c, r_c, 1e-13, what="cell centre")
    _close(tbase.filter_width(ts.geom), rbase.filter_width(rs.geom), 1e-13,
           what="filter width")


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_diffusive_cell_nu_matches_reference(grid):
    """div(nu grad u) with nu = nu0 + a cell field: the transverse-face
    corner averages of ops.diffusive, to 1e-13."""
    rs, ts = _sims(grid)
    arrs = _velocity(ts, 1)
    nut = np.abs(np.random.default_rng(2).standard_normal(
        (ts.cfg.Nx, ts.cfg.Ny, ts.cfg.Nz))) * 1e-2
    want = rops.diffusive(_j(arrs), ts.cfg.nu + jnp.asarray(nut), rs.geom)
    got = tops.diffusive(_t(arrs), ts.cfg.nu + torch.from_numpy(nut),
                         ts.geom)
    for g, w in zip(got, want):
        _close(g, w, 1e-13)
    # a 0-d tensor viscosity stays the scalar path
    want0 = rops.diffusive(_j(arrs), jnp.asarray(ts.cfg.nu), rs.geom)
    got0 = tops.diffusive(_t(arrs), torch.tensor(ts.cfg.nu, dtype=torch.float64),
                          ts.geom)
    for g, w in zip(got0, want0):
        _close(g, w, 1e-13)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("closure", sorted(CLOSURES))
def test_nu_sgs_twin_matches_pallas(closure, grid):
    """nu_sgs_twin and the nu_sgs wrapper (its twin on the CPU) against
    the reference's fused_nu_sgs in interpret mode, to 1e-14."""
    rs, ts = _sims(grid, turb_model=closure, use_pallas="on")
    arrs = _velocity(ts, 3)
    want = PK.fused_nu_sgs(*_j(arrs), geom=rs.geom,
                           model_fn=rs.turb._model_fn, interpret=True)
    kw = dict(geom=ts.geom, closure=closure, coeff=CLOSURES[closure])
    _close(K.nu_sgs_twin(*_t(arrs), **kw), want, 1e-14)
    _close(K.nu_sgs(*_t(arrs), K.les_arrays(ts.geom), **kw), want, 1e-14)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_germano_pass1_twin_matches_pallas(grid):
    """germano_pass1_twin against the reference's fused_germano_pass1 in
    interpret mode: |S| to rtol 1e-14 (|S| is O(50) for these unit-variance
    fields), the L:M and M:M plane sums to rtol 1e-12 (the reference sums
    slab by slab)."""
    rs, ts = _sims(grid, turb_model="dynamic_smagorinsky", use_pallas="on")
    arrs = _velocity(ts, 4)
    w_s, w_lm, w_mm = PK.fused_germano_pass1(*_j(arrs), geom=rs.geom,
                                             interpret=True)
    for got in (K.germano_pass1_twin(*_t(arrs), geom=ts.geom),
                K.germano_pass1(*_t(arrs), K.les_arrays(ts.geom),
                                geom=ts.geom)):
        smag, lm, mm = got
        assert lm.shape == mm.shape == (1, ts.cfg.Ny, 1)
        _close(smag, w_s, 0.0, 1e-14, "|S|")
        _close(lm, w_lm, 0.0, 1e-12, "L:M")
        _close(mm, w_mm, 0.0, 1e-12, "M:M")


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("model", sorted(CLOSURES) + [
    "sigma", "dynamic_smagorinsky"])
def test_model_nu_t_matches_reference(model, mode):
    """Each closure's nu_t from the reference's perturbed channel, the port
    against the reference under the same use_pallas, at the reference's
    own limits (tests/test_pallas_kernels.py:145-147, :175)."""
    rs, ts = _sims(turb_model=model, use_pallas=mode)
    kernel = {"sigma": None, "dynamic_smagorinsky": "germano_pass1"}.get(
        model, "nu_sgs")
    assert ts.kernels == (KernelPlan("channel", "slab", kernel) if mode == "on"
                          else KernelPlan(None, None))
    state = R.perturbed_channel(rs.cfg, rs.mesh, amp=0.1)
    want = np.asarray(rs.turb.nu_t(state, rs))
    got = ts.turb.nu_t(_to_port(state, ts), ts)
    tol = {"sigma": dict(rtol=1e-5, atol=1e-12),
           "dynamic_smagorinsky": dict(rtol=1e-12, atol=1e-16)}.get(
        model, dict(rtol=0.0, atol=1e-14))
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert float(got.min()) >= 0.0 and float(got.max()) > 0.0


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("model", ["smagorinsky", "dynamic_smagorinsky"])
def test_les_channel_trajectory_matches_reference(model, mode):
    """5 steps of the stretched LES channel (central, Euler) from the
    reference's perturbed_channel: u, v, w, p to 1e-11, nu_t to 1e-12."""
    rs, ts = _sims(turb_model=model, use_pallas=mode)
    r = R.perturbed_channel(rs.cfg, rs.mesh, amp=0.1)
    t = _to_port(r, ts)
    assert t.nu_t is not None and float(t.nu_t.abs().max()) == 0.0
    for _ in range(5):
        r, rd = rs.step(r)
        t, td = ts.step(t)
    out = T.state_to_numpy(t)
    for k in ("u", "v", "w", "p"):
        _close(out[k], getattr(r, k), 1e-11, what=k)
    _close(out["nu_t"], r.nu_t, 1e-12, what="nu_t")
    assert float(np.max(out["nu_t"])) > 0.0
    assert float(td.div_linf) < 1e-10


def test_state_round_trip_carries_nu_t():
    _, ts = _sims(turb_model="wale")
    st = ts.initial_state()
    assert st.nu_t is not None and tuple(st.nu_t.shape) == (16, 12, 8)
    gen = torch.Generator().manual_seed(3)
    st = T.perturbed_channel(ts.cfg, ts.mesh, gen, amp=0.05, device="cpu")
    st = st.replace(nu_t=torch.rand(st.nu_t.shape, generator=gen,
                                    dtype=torch.float64))
    back = T.state_from_numpy(T.state_to_numpy(st), "cpu", torch.float64)
    assert torch.equal(back.nu_t, st.nu_t)
    # laminar states carry none
    _, lam = _sims()
    assert lam.initial_state().nu_t is None
    assert "nu_t" not in T.state_to_numpy(lam.initial_state())


PERIODIC = dict(Nx=16, Ny=16, Nz=16, bc_x="periodic", bc_y="periodic",
                bc_z="periodic", y_min=0.0, y_max=2 * np.pi,
                z_max=2 * np.pi, convective_scheme="skew",
                turb_model="smagorinsky")


def test_periodic_les_takes_no_periodic_predictor():
    """The all-periodic predictor has no nu_t operand (nor has the
    reference's fused_predictor): an LES run on an all-periodic skew grid
    plans the general predictor, never the periodic one, under 'on' and on
    a CUDA device, and matches the reference's LES Taylor-Green under 'on'
    and 'off'."""
    _, on = _sims(PERIODIC, use_pallas="on")
    assert on.kernels == KernelPlan("general", "slab", "nu_sgs")
    # the plans a CUDA device would get under "auto" (a plan allocates
    # nothing): only a laminar run takes the periodic kernel
    for model, plan in (("smagorinsky", KernelPlan("general", "slab",
                                                   "nu_sgs")),
                        ("none", KernelPlan("periodic", "slab", None))):
        _, auto = _sims(dict(PERIODIC, turb_model=model))
        auto.device = torch.device("cuda", 0)
        assert auto._select_kernels() == plan, model
    for mode in ("on", "off"):
        rs, ts = _sims(PERIODIC, use_pallas="off")
        if mode == "on":
            ts = on
        r = R.init_taylor_green(rs.cfg, rs.mesh)
        t = _to_port(r, ts)
        for _ in range(3):
            r, _ = rs.step(r)
            t, _ = ts.step(t)
        for k in ("u", "v", "w", "p", "nu_t"):
            _close(getattr(t, k), getattr(r, k), 1e-11, what=f"{mode} {k}")


def test_les_kernels_refuse_other_geometries():
    """nu_sgs serves a walled-z duct (its own gate, the reference's LES
    gate), and so does germano_pass1: its filter truncates at the walls of
    z and its wrapper matches the reference's fused_germano_pass1 there, so
    the plan a CUDA device would get, and use_pallas="on", run the dynamic
    closure through the kernel."""
    duct = dict(Nx=16, Ny=12, Nz=8, bc_z="wall", z_min=-1.0, z_max=1.0)
    _, ts = _sims(duct, turb_model="smagorinsky")
    assert K.nu_sgs_eligible(ts.geom) and K.germano_pass1_eligible(ts.geom)
    arrs = _velocity(ts, 5)
    u, v, w = _t(arrs)
    gs = K.les_arrays(ts.geom)
    nut = K.nu_sgs(u, v, w, gs, geom=ts.geom, closure="smagorinsky",
                   coeff=0.17)
    _close(nut, K.nu_sgs_twin(u, v, w, geom=ts.geom, closure="smagorinsky",
                              coeff=0.17), 0.0)
    rs, _ = _sims(duct, turb_model="dynamic_smagorinsky")
    w_s, w_lm, w_mm = PK.fused_germano_pass1(*_j(arrs), geom=rs.geom,
                                             interpret=True)
    smag, lm, mm = K.germano_pass1(u, v, w, gs, geom=ts.geom)
    _close(smag, w_s, 0.0, 1e-14, "|S|")
    _close(lm, w_lm, 0.0, 1e-12, "L:M")
    _close(mm, w_mm, 0.0, 1e-12, "M:M")
    ts.device = torch.device("cuda", 0)
    assert ts._select_kernels().closure == "nu_sgs"
    _, dyn = _sims(duct, turb_model="dynamic_smagorinsky")
    dyn.device = torch.device("cuda", 0)
    assert dyn._select_kernels().closure == "germano_pass1"
    _, on = _sims(duct, turb_model="dynamic_smagorinsky", use_pallas="on")
    assert on.kernels == KernelPlan("general", "slab", "germano_pass1")
    with pytest.raises(ValueError, match="closure"):
        K.nu_sgs(u, v, w, gs, geom=ts.geom, closure="sigma", coeff=1.35)


def test_les_refusal_names_the_x_gate():
    """On a wall-x lid cavity with WALE the nu_sgs gate's refusal names its
    failing condition, a periodic x, not another kernel's. use_pallas="on"
    does not raise there: the reference's LES gate never fuses a closure
    on a non-periodic x (les.py:37-39), so the plan runs the xpad
    predictor with the plain closure, as the reference's "on"."""
    cfg = _cfg(T, Nx=12, Ny=12, Nz=12, bc_x="wall", x_max=1.5, y_min=0.0,
               y_max=1.0, z_max=2.0, lid_velocity=1.0, turb_model="wale",
               use_pallas="on")
    sim = T.Simulation(cfg, device="cpu")
    why = K.les_refusal("nu_sgs", sim.geom)
    assert "nu_sgs needs a periodic uniform x" in why
    assert "germano" not in why
    assert sim.kernels == KernelPlan("xpad", None, None)


def test_les_refusal_names_the_xz_wall_gate(monkeypatch):
    """use_pallas="on" on a lid channel with Smagorinsky in the "xz" plan
    (the slab cap lowered): the refusal names nu_sgs_xz and its failing
    condition, stationary walls."""
    from cfdnn_tpu_torch import solver as TS
    monkeypatch.setattr(TS, "SLAB_FIT_CELLS", 8)
    cfg = _cfg(T, Nx=16, Ny=12, Nz=32, stretch_y=True, lid_velocity=1.0,
               turb_model="smagorinsky", use_pallas="on")
    with pytest.raises(NotImplementedError) as err:
        T.Simulation(cfg, device="cpu")
    assert "nu_sgs_xz needs stationary walls" in str(err.value)
    assert "germano" not in str(err.value)
    # the same grid in "auto" plans the xz predictor with the plain closure
    sim = T.Simulation(cfg.with_(use_pallas="auto"), device="cpu")
    sim.device = torch.device("cuda", 0)
    assert sim._select_kernels() == KernelPlan("general_xz", "xz")


def test_les_wrapper_gradients_match_twin():
    """The autograd bridge of nu_sgs and germano_pass1: gradients through
    the wrappers equal those of autograd through the twins (the
    reference's vjp_via)."""
    _, ts = _sims(turb_model="vreman")
    g, gs = ts.geom, K.les_arrays(ts.geom)
    base = _t(_velocity(ts, 6))

    def grads(nu_fn, germano_fn):
        xs = [a.clone().requires_grad_() for a in base]
        smag, lm, mm = germano_fn(*xs)
        loss = nu_fn(*xs).square().sum() + smag.sum() + (lm * mm).sum()
        loss.backward()
        return [x.grad for x in xs]

    got = grads(lambda *xs: K.nu_sgs(*xs, gs, geom=g, closure="vreman",
                                     coeff=0.07),
                lambda *xs: K.germano_pass1(*xs, gs, geom=g))
    want = grads(lambda *xs: K.nu_sgs_twin(*xs, geom=g, closure="vreman",
                                           coeff=0.07),
                 lambda *xs: K.germano_pass1_twin(*xs, geom=g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_les_channel_bench_config():
    """bench.les_channel_config is the reference's bench_les_channel row
    (bench.py:98-103), cut to n; a few CPU steps run it through its
    closure and stay finite and solenoidal."""
    cfg = bench.les_channel_config().finalize()
    assert (cfg.Nx, cfg.Ny, cfg.Nz) == (128, 64, 128) and cfg.stretch_y
    assert (cfg.nu, cfg.dp_dx, cfg.dt, cfg.dtype) == (1e-4, -1e-3, 2e-4,
                                                      "float32")
    assert cfg.turb_model == T.TurbulenceModel.SMAGORINSKY and cfg.benchmark
    assert cfg.convective_scheme == T.ConvectiveScheme.CENTRAL
    sim, st = bench.les_channel_case(16, device="cpu", dtype="float64")
    st, d = sim.run(st, 3)
    assert bool(torch.isfinite(st.nu_t).all()) and float(st.nu_t.max()) > 0
    assert float(d.div_linf) < 1e-10
