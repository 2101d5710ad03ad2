"""The port's predictor + divergence kernels (predictor_periodic_div,
predictor_channel_div) and the CFDNN_FUSE_DIV=1 path of its Simulation,
against the JAX reference at float64 on the CPU.

Inputs from np.random.default_rng handed across as NumPy arrays; the
reference's Pallas kernels run as its own tests run them
(`fused_*(..., interpret=True)`, tests/test_pallas_kernels.py:364-432),
the port's wrappers take their plain twins on CPU tensors. Limits, the
reference's own: the star 1e-13, div 1e-11, 4-step trajectories 1e-12
(u, v, w, p; tests/test_pallas_kernels.py:435-473).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.solver import KernelPlan

PERIODIC = dict(Nx=16, Ny=16, Nz=16, bc_x="periodic", bc_y="periodic",
                bc_z="periodic", y_min=0.0, y_max=1.0, x_max=1.0, z_max=2.0,
                nu=3e-3, nu_specified=True, dp_dx=-0.7, dp_dx_specified=True,
                dt=1e-3, adaptive_dt=False, dtype="float64",
                convective_scheme="skew")
CHANNEL = dict(Nx=16, Ny=12, Nz=8, nu=3e-3, nu_specified=True, dp_dx=-2e-3,
               dp_dx_specified=True, dt=1e-3, adaptive_dt=False,
               dtype="float64")
TGV = dict(PERIODIC, y_max=2 * np.pi, x_max=2 * np.pi, z_max=2 * np.pi,
           nu=1e-3, dp_dx=0.0)
CHANNEL_RUN = dict(CHANNEL, Ny=24, stretch_y=True, z_max=1.0, nu=1e-3,
                   dp_dx=-1e-3)


def _cfg(pkg, **kw):
    for name, enum_ in (("bc_x", pkg.BCType), ("bc_y", pkg.BCType),
                        ("bc_z", pkg.BCType),
                        ("convective_scheme", pkg.ConvectiveScheme),
                        ("turb_model", pkg.TurbulenceModel)):
        if name in kw:
            kw[name] = enum_(kw[name])
    return pkg.Config(**kw)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, atol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol, err_msg=what)


def _check_outputs(got, want, what):
    """Star (u*, v*, w*) to 1e-13 and div to 1e-11."""
    for name, g, r in zip(("u*", "v*", "w*"), got[:3], want[:3]):
        _close(g, r, 1e-13, f"{what} {name}")
    _close(got[3], want[3], 1e-11, f"{what} div")


def test_predictor_periodic_div_matches_pallas():
    """predictor_periodic_div_twin and the wrapper (its twin on the CPU)
    against the reference's fused_predictor_div in interpret mode."""
    rs = R.Simulation(_cfg(R, **PERIODIC))
    ts = T.Simulation(_cfg(T, **PERIODIC), device="cpu")
    rng = np.random.default_rng(3)
    comps = [rng.standard_normal((16, 16, 16)) for _ in range(3)]
    dt, fx = 1e-3, 0.7
    g = rs.geom
    want = PK.fused_predictor_div(*(jnp.asarray(c) for c in comps), dt,
                                  hx=g.x.h, hy=g.y.h, hz=g.z.h, nu=3e-3,
                                  fx=fx, bx=4, interpret=True)
    u, v, w = (_t(c) for c in comps)
    dt_t = torch.tensor(dt, dtype=torch.float64)
    kw = dict(geom=ts.geom, nu=3e-3, fx=fx)
    _check_outputs(K.predictor_periodic_div_twin(u, v, w, dt_t, **kw), want,
                   "twin")
    _check_outputs(K.predictor_periodic_div(u, v, w, dt_t, **kw), want,
                   "wrapper")


@pytest.mark.parametrize("stretch", [False, True])
@pytest.mark.parametrize("with_nut", [False, True])
@pytest.mark.parametrize("scheme", ["skew", "central"])
def test_predictor_channel_div_matches_pallas(stretch, with_nut, scheme):
    """predictor_channel_div_twin and the wrapper against the reference's
    fused_predictor_channel_div in interpret mode (v's wall faces zeroed
    in both), uniform and stretched y, scalar nu and nu_t, skew and
    central."""
    kw = dict(CHANNEL, stretch_y=stretch, convective_scheme=scheme)
    rs = R.Simulation(_cfg(R, **kw))
    ts = T.Simulation(_cfg(T, **kw), device="cpu")
    rng = np.random.default_rng(4)
    comps = [rng.standard_normal(s) for s in T.velocity_shapes(ts.cfg)]
    nut = (np.abs(rng.standard_normal((16, 12, 8))) * 1e-2 if with_nut
           else None)
    dt, fx = 1e-3, 2e-3
    want = PK.fused_predictor_channel_div(
        *(jnp.asarray(c) for c in comps), dt, geom=rs.geom, nu=3e-3, fx=fx,
        scheme=rs.cfg.convective_scheme,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    u, v, w = (_t(c) for c in comps)
    dt_t = torch.tensor(dt, dtype=torch.float64)
    ys = K.channel_y_arrays(ts.geom)
    kw = dict(geom=ts.geom, nu=3e-3, fx=fx, scheme=ts.cfg.convective_scheme)
    twin = K.predictor_channel_div_twin(u, v, w, dt_t, *ys, _t(nut), **kw)
    _check_outputs(twin, want, "twin")
    got = K.predictor_channel_div(u, v, w, dt_t, ys, nu_t=_t(nut), **kw)
    _check_outputs(got, want, "wrapper")
    assert float(got[1][:, 0].abs().max()) == float(
        got[1][:, -1].abs().max()) == 0.0


CASES = {
    "periodic": (TGV, "tgv", KernelPlan("periodic", "slab")),
    "channel": (CHANNEL_RUN, "channel", KernelPlan("channel", "slab")),
    "les_channel": (dict(CHANNEL_RUN, turb_model="smagorinsky"), "channel",
                    KernelPlan("channel", "slab", "nu_sgs")),
}


def _initial(rs, start):
    if start == "tgv":
        return R.init_taylor_green(rs.cfg, rs.mesh)
    return R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05)


def _to_port(r):
    keys = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "nu_t")
    return T.state_from_numpy({k: np.asarray(getattr(r, k)) for k in keys
                               if getattr(r, k) is not None}, "cpu",
                              torch.float64)


def _count_calls(monkeypatch, names):
    """Count the solver's calls of the named ops.kernels wrappers."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(K, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(K, name, spy)
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_trajectory_matches_reference(case, monkeypatch):
    """CFDNN_FUSE_DIV=1: 4 Euler steps of the port under use_pallas="on"
    (its div wrapper's twin on the CPU) against the reference's operator
    chain ("off"), u, v, w, p to 1e-12; each step calls the div wrapper
    once and the divergence wrapper never."""
    monkeypatch.setenv("CFDNN_FUSE_DIV", "1")
    grid, start, plan = CASES[case]
    rs = R.Simulation(_cfg(R, **grid, use_pallas="off"))
    ts = T.Simulation(_cfg(T, **grid, use_pallas="on"), device="cpu")
    assert ts.kernels == plan
    assert ts._fuse_div == plan.predictor
    div_name = f"predictor_{plan.predictor}_div"
    calls = _count_calls(monkeypatch, (div_name, "divergence"))
    r = _initial(rs, start)
    t = _to_port(r)
    for _ in range(4):
        r, _ = rs.step(r)
        t, td = ts.step(t)
    assert calls == {div_name: 4, "divergence": 0}
    out = T.state_to_numpy(t)
    for k in ("u", "v", "w", "p"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(r, k)), rtol=0,
                                   atol=1e-12, err_msg=k)
    assert float(td.div_linf) < 1e-10


def test_les_tgv_with_the_opt_in_runs_unfused(monkeypatch):
    """An all-periodic LES run under CFDNN_FUSE_DIV=1: the reference's gate
    says "periodic" there and its step then fails its assert (its general
    kernel produces no div); the port keys the gate to its plan (the
    general predictor), runs unfused, and matches the reference run
    without the opt-in: u, v, w, p to 1e-11, nu_t to 1e-12."""
    grid = dict(TGV, nu=1.0 / 1600.0, turb_model="smagorinsky")
    rs = R.Simulation(_cfg(R, **grid, use_pallas="off"))
    monkeypatch.setenv("CFDNN_FUSE_DIV", "1")
    ts = T.Simulation(_cfg(T, **grid, use_pallas="on"), device="cpu")
    assert ts.kernels == KernelPlan("general", "slab", "nu_sgs")
    assert ts._fuse_div is False
    calls = _count_calls(monkeypatch, ("predictor_periodic_div",
                                       "predictor_channel_div", "divergence"))
    r = R.init_taylor_green(rs.cfg, rs.mesh)
    t = _to_port(r)
    for _ in range(3):
        r, _ = rs.step(r)
        t, _ = ts.step(t)
    assert calls == {"predictor_periodic_div": 0, "predictor_channel_div": 0,
                     "divergence": 3}
    out = T.state_to_numpy(t)
    for k in ("u", "v", "w", "p"):
        np.testing.assert_allclose(out[k], np.asarray(getattr(r, k)), rtol=0,
                                   atol=1e-11, err_msg=k)
    np.testing.assert_allclose(out["nu_t"], np.asarray(r.nu_t), rtol=0,
                               atol=1e-12)


def test_opt_in_is_read_at_construction(monkeypatch):
    """The opt-in holds only with CFDNN_FUSE_DIV equal to "1" when the
    Simulation is built, and only on a plan whose predictor has a div
    kernel (periodic or channel, under "on" or CUDA "auto")."""
    tcfg = _cfg(T, **TGV, use_pallas="on")
    monkeypatch.delenv("CFDNN_FUSE_DIV", raising=False)
    sim = T.Simulation(tcfg, device="cpu")
    monkeypatch.setenv("CFDNN_FUSE_DIV", "1")
    assert sim._fuse_div is False
    assert T.Simulation(tcfg, device="cpu")._fuse_div == "periodic"
    assert T.Simulation(_cfg(T, **TGV, use_pallas="off"),
                        device="cpu")._fuse_div is False
    monkeypatch.setenv("CFDNN_FUSE_DIV", "yes")
    assert T.Simulation(tcfg, device="cpu")._fuse_div is False


def test_div_wrapper_gradients_match_twin():
    """The autograd bridge of both div wrappers: gradients through the
    wrappers equal those of autograd through the twins."""
    ts = T.Simulation(_cfg(T, **CHANNEL, stretch_y=True), device="cpu")
    tp = T.Simulation(_cfg(T, **dict(PERIODIC, Nx=8, Ny=8, Nz=8)),
                      device="cpu")
    rng = np.random.default_rng(7)
    ys = K.channel_y_arrays(ts.geom)
    kc = dict(geom=ts.geom, nu=3e-3, fx=0.3, scheme=T.ConvectiveScheme.SKEW)
    kp = dict(geom=tp.geom, nu=3e-3, fx=0.3)
    cases = (
        (tp, lambda u, v, w, dt: K.predictor_periodic_div(u, v, w, dt, **kp),
         lambda u, v, w, dt: K.predictor_periodic_div_twin(u, v, w, dt,
                                                           **kp)),
        (ts, lambda u, v, w, dt: K.predictor_channel_div(u, v, w, dt, ys,
                                                         **kc),
         lambda u, v, w, dt: K.predictor_channel_div_twin(u, v, w, dt, *ys,
                                                          **kc)),
    )
    for sim, wrapper, twin in cases:
        base = [_t(rng.standard_normal(s))
                for s in T.velocity_shapes(sim.cfg)]
        base.append(torch.tensor(1e-2, dtype=torch.float64))
        grads = []
        for fn in (wrapper, twin):
            xs = [a.clone().requires_grad_() for a in base]
            su, sv, sw, dv = fn(*xs)
            (su.square().sum() + (sv * sv.flip(0)).sum() + sw.sin().sum()
             + dv.cos().sum()).backward()
            grads.append([x.grad for x in xs])
        for a, b in zip(*grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-12)


def test_div_wrappers_refuse_other_grids():
    """The div wrappers raise on a grid outside their kernel: the periodic
    one on the channel, the channel one on the periodic box."""
    ts = T.Simulation(_cfg(T, **CHANNEL), device="cpu")
    tp = T.Simulation(_cfg(T, **PERIODIC), device="cpu")
    dt = torch.tensor(1e-3, dtype=torch.float64)
    uc, vc, wc = (torch.zeros(s, dtype=torch.float64)
                  for s in T.velocity_shapes(ts.cfg))
    up, vp, wp = (torch.zeros(s, dtype=torch.float64)
                  for s in T.velocity_shapes(tp.cfg))
    with pytest.raises(NotImplementedError, match="all-periodic"):
        K.predictor_periodic_div(uc, vc, wc, dt, geom=ts.geom, nu=1e-3,
                                 fx=0.0)
    with pytest.raises(NotImplementedError, match="no-slip y"):
        K.predictor_channel_div(up, vp, wp, dt, (), geom=tp.geom, nu=1e-3,
                                fx=0.0, scheme=T.ConvectiveScheme.SKEW)
    with pytest.raises(ValueError, match="shape"):
        K.predictor_periodic_div(up, vp[:, :-1], wp, dt, geom=tp.geom,
                                 nu=1e-3, fx=0.0)


@pytest.mark.cuda
def test_div_kernels_match_twins_on_cuda():
    """The two div kernels against their twins on the card, float32 at
    32^3 (the LES channel case 32x16x32), each output to 1e-5 * max|twin
    output|, and div to 1e-5 of scale against the divergence kernel of the
    kernel's own star (chip_smoke._div_cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    for case in chip_smoke._div_cases(32, torch.float32, dev, 0):
        got, ref = case.kern(), case.twin()
        for out, err, lim, _ in chip_smoke.compare(case.name, got, ref,
                                                   torch.float32):
            assert err <= lim, f"{case.label} {out}: {err} > {lim}"
        err, lim = chip_smoke.own_star_div_error(got, case.geom,
                                                 torch.float32)
        assert err <= lim, f"{case.label} div vs own star: {err} > {lim}"
