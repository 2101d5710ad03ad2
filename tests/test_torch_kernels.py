"""The port's kernel twins (cfdnn_tpu_torch.ops.kernels) against the JAX
reference's Pallas kernels, run as tests/test_pallas_kernels.py runs them
(`fused_*(..., interpret=True)` on the CPU), at float64 to atol 1e-12.

On the CPU the public wrappers take the twins; the CUDA kernels themselves
are held to the twins on the card (the `cuda` test below, and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.ops import operators as tops

ATOL = 1e-12


def _sims(**kw):
    base = dict(nu=3e-3, nu_specified=True, dp_dx=-2e-3, dp_dx_specified=True,
                dt=1e-3, adaptive_dt=False, dtype="float64")
    base.update(kw)
    rkw, tkw = dict(base), dict(base)
    for k, v in base.items():
        if k.startswith("bc_"):
            rkw[k], tkw[k] = R.BCType(v), T.BCType(v)
        if k == "convective_scheme":
            rkw[k], tkw[k] = R.ConvectiveScheme(v), T.ConvectiveScheme(v)
    return (R.Simulation(R.Config(**rkw)),
            T.Simulation(T.Config(**tkw), device="cpu"))


PERIODIC = dict(Nx=16, Ny=16, Nz=16, bc_y="periodic", y_min=0.0, y_max=1.0,
                x_max=1.0, z_max=2.0, convective_scheme="skew")
CHANNEL = dict(Nx=16, Ny=12, Nz=8, z_max=1.0)


def _fields(sim, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in T.velocity_shapes(sim.cfg)]


def _t(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def _close(got, want, what=""):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=what)


def test_predictor_periodic_twin_matches_pallas():
    rs, ts = _sims(**PERIODIC)
    arrs = _fields(ts, 0)
    g = rs.geom
    kw = dict(hx=g.x.h, hy=g.y.h, hz=g.z.h, nu=rs.cfg.nu, fx=0.7)
    want = PK.fused_predictor(*(jnp.asarray(a) for a in arrs), 1e-3, bx=4,
                              interpret=True, **kw)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    _close(K.predictor_periodic_twin(*_t(arrs), dt, **kw), want)
    _close(K.predictor_periodic(*_t(arrs), dt, **kw), want)


@pytest.mark.parametrize("scheme", ["skew", "central"])
@pytest.mark.parametrize("stretch", [False, True])
def test_predictor_channel_twin_matches_pallas(scheme, stretch):
    rs, ts = _sims(**CHANNEL, stretch_y=stretch, convective_scheme=scheme)
    assert PK.channel_slab_eligible(rs.geom, rs.cfg)
    assert K.channel_slab_eligible(ts.geom, ts.cfg)
    arrs = _fields(ts, 1)
    fx = float(-rs.cfg.dp_dx / rs.cfg.rho)
    want = PK.fused_predictor_channel(
        *(jnp.asarray(a) for a in arrs), 1e-3, geom=rs.geom, nu=rs.cfg.nu,
        fx=fx, scheme=rs.cfg.convective_scheme, interpret=True)
    ys = K.channel_y_arrays(ts.geom)
    for a, b in zip(ys, PK._channel_y_arrays(rs.geom)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=0)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    kw = dict(hx=ts.geom.x.h, hz=ts.geom.z.h, nu=ts.cfg.nu, fx=fx,
              scheme=ts.cfg.convective_scheme)
    _close(K.predictor_channel_twin(*_t(arrs), dt, *ys, **kw), want)
    _close(K.predictor_channel(*_t(arrs), dt, ys, **kw), want)


@pytest.mark.parametrize("scheme", ["skew", "central"])
@pytest.mark.parametrize("stretch", [False, True])
def test_predictor_channel_nu_t_twin_matches_pallas(scheme, stretch):
    """The cell nu_t operand (LES): the twin against the reference's
    fused_predictor_channel(nu_t=...) in interpret mode and against the
    port's operator chain with nu + nu_t, to 1e-13 (the reference's limit,
    tests/test_pallas_kernels.py:349-361)."""
    rs, ts = _sims(**CHANNEL, stretch_y=stretch, convective_scheme=scheme)
    arrs = _fields(ts, 6)
    rng = np.random.default_rng(7)
    nut = np.abs(rng.standard_normal((ts.cfg.Nx, ts.cfg.Ny, ts.cfg.Nz))) * 1e-2
    fx = float(-rs.cfg.dp_dx / rs.cfg.rho)
    want = PK.fused_predictor_channel(
        *(jnp.asarray(a) for a in arrs), 1e-3, geom=rs.geom, nu=rs.cfg.nu,
        fx=fx, scheme=rs.cfg.convective_scheme, nu_t=jnp.asarray(nut),
        interpret=True)
    ys = K.channel_y_arrays(ts.geom)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    kw = dict(hx=ts.geom.x.h, hz=ts.geom.z.h, nu=ts.cfg.nu, fx=fx,
              scheme=ts.cfg.convective_scheme)
    nut_t = torch.from_numpy(nut)
    got = K.predictor_channel_twin(*_t(arrs), dt, *ys, nut_t, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-13)
    got = K.predictor_channel(*_t(arrs), dt, ys, nu_t=nut_t, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-13)
    comps = _t(arrs)
    conv = tops.convective(comps, ts.geom,
                                      ts.cfg.convective_scheme)
    diff = tops.diffusive(comps, ts.cfg.nu + nut_t, ts.geom)
    chain = (comps[0] + 1e-3 * (-conv[0] + diff[0] + fx),
             comps[1] + 1e-3 * (-conv[1] + diff[1]),
             comps[2] + 1e-3 * (-conv[2] + diff[2]))
    # the twin's star v carries the wall faces the BC pass zeroes
    for c, (g, w) in enumerate(zip(got, chain)):
        if c == 1:
            g, w = g[:, 1:-1], w[:, 1:-1]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize("grid", ["periodic", "channel"])
def test_divergence_and_correct_twins_match_pallas(grid):
    rs, ts = _sims(**(PERIODIC if grid == "periodic" else
                      dict(CHANNEL, stretch_y=True)))
    arrs = _fields(ts, 2)
    p = np.random.default_rng(3).standard_normal(
        (ts.cfg.Nx, ts.cfg.Ny, ts.cfg.Nz))
    ja = [jnp.asarray(a) for a in arrs]
    want_div = PK.fused_divergence(*ja, geom=rs.geom, interpret=True)
    want_cor = PK.fused_correct(*ja, jnp.asarray(p), 1e-3, geom=rs.geom,
                                interpret=True)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    pt = torch.from_numpy(p.copy())
    _close(K.divergence_twin(*_t(arrs), geom=ts.geom), want_div, "div")
    _close(K.divergence(*_t(arrs), geom=ts.geom), want_div, "div")
    _close(K.correct_twin(*_t(arrs), pt, dt, geom=ts.geom), want_cor, "cor")
    _close(K.correct(*_t(arrs), pt, dt, geom=ts.geom), want_cor, "cor")


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the twins: no kernel launch is
    counted."""
    _, ts = _sims(**dict(CHANNEL, stretch_y=True))
    K.reset_launch_counts()
    state = T.perturbed_channel(ts.cfg, ts.mesh, amp=0.05, device="cpu")
    # the CPU "auto" plan runs the eager operators
    assert ts.kernels == T.solver.KernelPlan(None, None)
    u, v, w = state.velocity
    dt = torch.tensor(1e-3, dtype=torch.float64)
    K.divergence(u, v, w, geom=ts.geom)
    K.correct(u, v, w, state.p, dt, geom=ts.geom)
    K.predictor_channel(u, v, w, dt, K.channel_y_arrays(ts.geom),
                        hx=ts.geom.x.h, hz=ts.geom.z.h, nu=1e-3, fx=0.0,
                        scheme=T.ConvectiveScheme.CENTRAL,
                        nu_t=torch.zeros_like(state.p))
    gs = K.les_arrays(ts.geom)
    K.nu_sgs(u, v, w, gs, geom=ts.geom, closure="wale", coeff=0.325)
    K.germano_pass1(u, v, w, gs, geom=ts.geom)
    assert K.launch_counts() == {k.__name__: 0 for k in K.KERNELS}


def test_wrapper_gradients_match_twin():
    """The autograd bridge: gradients through a wrapper equal those of
    autograd through its twin."""
    _, ts = _sims(**PERIODIC)
    base = _t(_fields(ts, 4))
    dt0 = torch.tensor(1e-2, dtype=torch.float64)
    g = ts.geom
    kw = dict(hx=g.x.h, hy=g.y.h, hz=g.z.h, nu=3e-3, fx=0.5)
    grads = []
    for fn in (K.predictor_periodic, K.predictor_periodic_twin):
        xs = [a.clone().requires_grad_() for a in base]
        dt = dt0.clone().requires_grad_()
        su, sv, sw = fn(*xs, dt, **kw)
        div = K.divergence(su, sv, sw, geom=g)
        (div.square().sum() + (su * sv * sw).sum()).backward()
        grads.append([x.grad for x in xs] + [dt.grad])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_wrappers_check_inputs():
    _, ts = _sims(**PERIODIC)
    u, v, w = _t(_fields(ts, 5))
    g = ts.geom
    dt = torch.tensor(1e-3, dtype=torch.float64)
    kw = dict(hx=g.x.h, hy=g.y.h, hz=g.z.h, nu=1e-3, fx=0.0)
    with pytest.raises(TypeError):
        K.predictor_periodic(u, v, w, 1e-3, **kw)           # dt not a tensor
    with pytest.raises(TypeError):
        K.predictor_periodic(u, v.float(), w, dt, **kw)     # mixed dtypes
    with pytest.raises(TypeError):
        K.divergence(u.half(), v.half(), w.half(), geom=g)  # half
    with pytest.raises(ValueError):
        K.predictor_periodic(u, v[:, :-1], w, dt, **kw)     # shape
    with pytest.raises(ValueError):
        K.divergence(u.transpose(0, 2), v, w, geom=g)       # not contiguous
    with pytest.raises(ValueError):
        K.divergence(u.float(), v.float(), w.float(), geom=g)  # geom dtype
    with pytest.raises(NotImplementedError, match="skew and central"):
        K.predictor_channel_twin(u, v, w, dt, *K.channel_y_arrays(g),
                                 hx=1.0, hz=1.0, nu=1e-3, fx=0.0,
                                 scheme=T.ConvectiveScheme.UPWIND)


@pytest.mark.cuda
def test_kernels_match_twins_float32_on_cuda():
    """Each CUDA kernel against its twin on the card, float32, each output
    to 1e-5 * max|twin output| (the kernels sum in another order than the
    twins)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    for case in chip_smoke._cases(32, torch.float32, dev, 0):
        got, ref = case.kern(), case.twin()
        for out, err, lim, _ in chip_smoke.compare(case.name, got, ref,
                                                   torch.float32):
            assert err <= lim, f"{case.label} {out}: {err} > {lim}"
