"""The port's Hartley-transform Poisson path (poisson/pallas_fht.py,
poisson/fht.py, ops.kernels.fht_pass / fht_modal, the "pallas_fft" and
"fht" transforms of FDMPoissonSolver) against the JAX reference on the CPU.

Inputs are made with NumPy from a seed and go to both packages. The
reference's Pallas kernels run in interpret mode, as its own tests run
them; the port's wrappers take their plain twins on CPU tensors. Limits:
each pass and the modal pass 1e-12 of scale in float64 (every axis,
forward and inverse, N1 = 1 ... 8); float32 against float64 5e-6 relative
(the reference's own bound); the solves 1e-11 relative and their
residual < 1e-12; 5-step trajectories 1e-11 of each field's scale.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.mesh import Mesh as RMesh
from cfdnn_tpu.poisson import fht as rfht
from cfdnn_tpu.poisson import pallas_fht as rp
from cfdnn_tpu.poisson.fdm import FDMPoissonSolver as RFDM
from cfdnn_tpu_torch import bench
from cfdnn_tpu_torch.mesh import Mesh as TMesh
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.poisson import fht as tfht
from cfdnn_tpu_torch.poisson import pallas_fht as tp
from cfdnn_tpu_torch.poisson.fdm import FDMPoissonSolver as TFDM

F64 = 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


def _shape(axis, N):
    """The reference tests' shapes (test_pallas_fht.py _axis_shapes)."""
    return {0: (N, 8, 128), 1: (8, N, 128), 2: (8, 16, N)}[axis]


def _axes(N1, dtype=np.float64):
    """The reference's and the port's constants of N = 32*N1 with the fast
    digit forced to 32."""
    N = 32 * N1
    r = rp.PFHTAxis.make(N, jnp.dtype(dtype), n2=32)
    t = tp.PFHTAxis.make(N, getattr(torch, np.dtype(dtype).name), n2=32,
                         device="cpu")
    assert (r.N1, r.N2) == (t.N1, t.N2) == (N1, 32)
    return r, t


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("N1", range(1, 9))
def test_pass_matches_pallas(N1, axis):
    """fht_pass forward and inverse == fht_pallas (float64, interpret)."""
    r, t = _axes(N1)
    x = _data(_shape(axis, r.N), 10 * N1 + axis)
    for inverse in (False, True):
        want = rp.fht_pallas(jnp.asarray(x), axis, r, inverse=inverse,
                             interpret=True)
        got = K.fht_pass(torch.from_numpy(x), axis, t, inverse=inverse)
        assert got.dtype == torch.float64 and got.shape == x.shape
        assert _rel(got.numpy(), want) <= F64, (N1, axis, inverse)


def _lams(shape, axis, seed):
    """A symbol like the solver's: lam_axis <= 0 with a 0 (a null mode)
    and lam_rest <= 0 with a 0 at the origin."""
    g = np.random.default_rng(seed)
    lam_axis = -np.abs(g.standard_normal(shape[axis]))
    lam_axis[0] = 0.0
    lam_rest = -np.abs(g.standard_normal(
        [s for a, s in enumerate(shape) if a != axis]))
    lam_rest.flat[0] = 0.0
    return lam_axis, lam_rest


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("N1", range(1, 9))
def test_modal_matches_pallas(N1, axis):
    """fht_modal == fht_pallas_modal (float64, interpret), the null mode
    pinned by thr."""
    r, t = _axes(N1)
    shape = _shape(axis, r.N)
    x = _data(shape, 20 * N1 + axis)
    lam_axis, lam_rest = _lams(shape, axis, N1)
    kw = dict(thr=1e-9, norm=0.37 / r.N)
    want = rp.fht_pallas_modal(jnp.asarray(x), axis, r, lam_axis,
                               jnp.asarray(lam_rest), interpret=True, **kw)
    got = K.fht_modal(torch.from_numpy(x), axis, t,
                      torch.from_numpy(lam_axis), torch.from_numpy(lam_rest),
                      **kw)
    assert _rel(got.numpy(), want) <= F64


# The splits the kernels' radix-3, 5 and 7 stages and their other
# power-of-two plans serve, N2 in {64, 96, 160, 192, 224, 256}, each with
# N1 = 1 and one N1 > 1 (the solver's own split, but N2 = 256 forced at
# N = 256, where the solver takes 2 x 128).
SPLITS = [(64, None), (320, None), (96, None), (480, None), (160, None),
          (800, None), (192, None), (576, None), (224, None), (1568, None),
          (256, 256), (2048, None)]


def _split_axes(N, n2):
    r = rp.PFHTAxis.make(N, jnp.float64, n2=n2)
    t = tp.PFHTAxis.make(N, torch.float64, n2=n2, device="cpu")
    assert (r.N1, r.N2) == (t.N1, t.N2) and t.N1 * t.N2 == N
    return r, t


def _split_shape(axis, N):
    shape = [4, 6, 5]
    shape[axis] = N
    return shape


@pytest.mark.parametrize("N,n2", SPLITS)
def test_pass_matches_pallas_at_split(N, n2):
    """fht_pass forward and inverse == fht_pallas (float64, interpret) on
    every axis at the split."""
    r, t = _split_axes(N, n2)
    for axis in range(3):
        x = _data(_split_shape(axis, N), N + axis)
        for inverse in (False, True):
            want = rp.fht_pallas(jnp.asarray(x), axis, r, inverse=inverse,
                                 interpret=True)
            got = K.fht_pass(torch.from_numpy(x), axis, t, inverse=inverse)
            assert _rel(got.numpy(), want) <= F64, (t.N1, t.N2, axis,
                                                    inverse)


@pytest.mark.parametrize("N,n2", SPLITS)
def test_modal_matches_pallas_at_split(N, n2):
    """fht_modal == fht_pallas_modal (float64, interpret) on every axis at
    the split, the null mode pinned by thr."""
    r, t = _split_axes(N, n2)
    kw = dict(thr=1e-9, norm=0.37 / N)
    for axis in range(3):
        shape = _split_shape(axis, N)
        x = _data(shape, 2 * N + axis)
        lam_axis, lam_rest = _lams(shape, axis, N + axis)
        want = rp.fht_pallas_modal(jnp.asarray(x), axis, r, lam_axis,
                                   jnp.asarray(lam_rest), interpret=True,
                                   **kw)
        got = K.fht_modal(torch.from_numpy(x), axis, t,
                          torch.from_numpy(lam_axis),
                          torch.from_numpy(lam_rest), **kw)
        assert _rel(got.numpy(), want) <= F64, (t.N1, t.N2, axis)


@pytest.mark.parametrize("N", [128, 512])
def test_default_split_matches_pallas_and_dense(N):
    """The solver's split (N1 = 1, N2 = 128 at 128; N1 = 4 at 512): each
    axis's forward pass == fht_pallas and == the dense digit-permuted
    Hartley matrix (the port's and the reference's reference_forward), and
    inverse(forward(x)) == N x."""
    r = rp.PFHTAxis.make(N, jnp.float64)
    t = tp.PFHTAxis.make(N, torch.float64, device="cpu")
    assert (t.N1, t.N2) == (r.N1, r.N2) == (N // 128, 128)
    for axis in range(3):
        shape = list(_shape(axis, N))
        if N == 512:          # keep the case under ~300k cells
            shape[(axis + 1) % 3] = 4
        x = _data(shape, N + axis)
        xt = torch.from_numpy(x)
        got = K.fht_pass(xt, axis, t)
        assert _rel(got.numpy(), rp.fht_pallas(
            jnp.asarray(x), axis, r, interpret=True)) <= F64
        dense = tp.reference_forward(xt, axis, t).numpy()
        assert _rel(dense, rp.reference_forward(jnp.asarray(x), axis,
                                                r)) <= F64
        assert _rel(got.numpy(), dense) <= F64
        back = K.fht_pass(got, axis, t, inverse=True) / N
        assert _rel(back.numpy(), x) <= F64


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_float32_within_float64(axis):
    """Float32 passes and the modal pass against float64 <= 5e-6 relative
    (norm), the reference's own float32 bound (test_pallas_fht.py:70-85);
    the port computes in float32 with no bf16 emulation."""
    N = 256
    t32 = tp.PFHTAxis.make(N, torch.float32, device="cpu")
    t64 = tp.PFHTAxis.make(N, torch.float64, device="cpu")
    shape = _shape(axis, N)
    x = _data(shape, 3 + axis)
    lam_axis, lam_rest = _lams(shape, axis, 7)
    kw = dict(thr=1e-9, norm=1.0 / N)
    for fn, args in ((K.fht_pass, {}), (K.fht_pass, dict(inverse=True)),
                     (K.fht_modal, None)):
        outs = []
        for t, dt in ((t32, torch.float32), (t64, torch.float64)):
            xt = torch.from_numpy(x).to(dt)
            if args is None:
                outs.append(fn(xt, axis, t, torch.from_numpy(lam_axis).to(dt),
                               torch.from_numpy(lam_rest).to(dt), **kw))
            else:
                outs.append(fn(xt, axis, t, **args))
        assert outs[0].dtype == torch.float32
        err = float(torch.linalg.norm(outs[0].double() - outs[1])
                    / torch.linalg.norm(outs[1]))
        assert err < 5e-6, (fn.__name__, args, err)


@pytest.mark.parametrize("N,n2", [(64, None), (128, None), (384, None),
                                  (512, None), (896, None), (2048, None),
                                  (160, 32), (224, 32)])
def test_pfht_axis_tables_match_reference(N, n2):
    """PFHTAxis: the split, H1 exactly, C2/S2 (the reference's csv_f) and
    the twiddles to 1e-12 (the port reduces k2*n2 mod N2 before the cosine),
    the kernel's table consistent with them, lam_permuted exactly."""
    r = rp.PFHTAxis.make(N, jnp.float64, n2=n2)
    t = tp.PFHTAxis.make(N, torch.float64, n2=n2, device="cpu")
    assert (t.N, t.N1, t.N2) == (r.N, r.N1, r.N2)
    assert t.H1 == r.H1
    N1, N2 = t.N1, t.N2
    csv = np.asarray(r.csv_f)
    np.testing.assert_allclose(t.C2.numpy(), csv[:N2], rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.S2.numpy(), csv[N2:], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(t.ctw.numpy(), np.asarray(r.ctw))
    np.testing.assert_array_equal(t.stw.numpy(), np.asarray(r.stw))
    tab = t.table.numpy()
    assert tab.shape == (2 * N2 + 2 * N + 128,)
    cs2 = tab[:2 * N2].reshape(N2, 2)
    red = np.outer(np.arange(N2), np.arange(N2)) % N2
    np.testing.assert_array_equal(cs2[red, 0], t.C2.numpy())
    np.testing.assert_array_equal(cs2[red, 1], t.S2.numpy())
    csn = tab[2 * N2:2 * N2 + 2 * N].reshape(N, 2)
    tw = np.outer(np.arange(N1), np.arange(N2))
    np.testing.assert_array_equal(csn[tw, 0], t.ctw.numpy())
    h1 = tab[2 * N2 + 2 * N:].reshape(2, 8, 8)
    np.testing.assert_array_equal(h1[0, :N1, :N1], np.asarray(r.H1))
    np.testing.assert_array_equal(
        h1[1, :N1, :N1], np.asarray(r.H1)[(N1 - np.arange(N1)) % N1])
    lam = np.random.default_rng(N).standard_normal(N)
    np.testing.assert_array_equal(t.lam_permuted(lam), r.lam_permuted(lam))


def test_axis_policy_and_fht_axis_match_reference():
    """axis_supported and _split_mxu over 1 ... 2048, and FHTAxis's split,
    tables and order, equal the reference's."""
    for n in range(1, 2049):
        assert tp.axis_supported(n) == rp.axis_supported(n), n
        assert tp._split_mxu(n) == rp._split_mxu(n), n
        assert tfht._split(n) == rfht._split(n), n
    for n in (32, 48, 64, 100):
        r = rfht.FHTAxis.make(n, jnp.float64)
        t = tfht.FHTAxis.make(n, torch.float64, device="cpu")
        assert (t.N1, t.N2) == (r.N1, r.N2)
        for name in ("H1", "C2", "S2", "cos_tw", "sin_tw"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(r, name)))
        x = _data((n, 6, 5), n)
        for axis in range(3):
            xa = np.moveaxis(x, 0, axis)
            f = tfht.fht_forward(torch.from_numpy(xa), axis, t)
            assert _rel(f.numpy(), rfht.fht_forward(jnp.asarray(xa), axis,
                                                    r)) <= F64
            assert _rel(tfht.fht_inverse(f, axis, t).numpy(), xa) <= F64


# ---------------------------------------------------------------------------
# FDMPoissonSolver
# ---------------------------------------------------------------------------


def _mk(pkg, n, bc, dtype="float64", **kw):
    """The reference tests' grid (test_pallas_fht.py _mk), O2."""
    cfg = pkg.Config(**dict(dict(
        Nx=n, Ny=n, Nz=n, bc_x=pkg.BCType.PERIODIC,
        bc_y=pkg.BCType.PERIODIC if bc == "periodic" else pkg.BCType.WALL,
        bc_z=pkg.BCType.PERIODIC, y_min=0.0, y_max=2 * np.pi, z_min=0.0,
        z_max=1.0, nu=1e-3, nu_specified=True, dp_dx=0.0,
        dp_dx_specified=True, dtype=dtype, stretch_y=bc == "wall"), **kw))
    mesh = (RMesh if pkg is R else TMesh).from_config(cfg)
    return mesh, cfg


# (bc, extra config, the port's axis kinds under pallas_fft)
SOLVER_GRIDS = {
    "periodic64": ("periodic", {}, "fht,fht,fht"),
    "wall64": ("wall", {}, "fht,eig,fht"),
    "duct64": ("wall", dict(bc_z="wall", stretch_y=False), "fht,eig,eig"),
    # N1 = 2 on x (N = 256 = 2 x 128), a 16-cell y taking the dense basis
    "x256": ("periodic", dict(Nx=256, Ny=16), "fht,eig,fht"),
}


def _solver_pair(grid, transform):
    bc, extra, _ = SOLVER_GRIDS[grid]
    out = []
    for pkg in (R, T):
        kw = dict(extra)
        if "bc_z" in kw:
            kw["bc_z"] = pkg.BCType(kw["bc_z"])
        mesh, cfg = _mk(pkg, 64, bc, **kw)
        out.append(RFDM(mesh, cfg, transform=transform) if pkg is R
                   else TFDM(mesh, cfg, transform=transform, device="cpu"))
    return out


@pytest.mark.parametrize("transform", ["pallas_fft", "fht"])
@pytest.mark.parametrize("grid", sorted(SOLVER_GRIDS))
def test_solver_matches_reference(grid, transform):
    """FDMPoissonSolver with "pallas_fft" / "fht" == the reference's same
    transform (float64, <= 1e-11 relative), the same axis kinds (the duct's
    modal pass on axis 0), and solve_with_stats' residual < 1e-12."""
    rs, ts = _solver_pair(grid, transform)
    assert ts.name == rs.name and ts.fht_axes == rs.fht_axes
    if transform == "pallas_fft":
        assert ts.name.startswith(f"FDM({SOLVER_GRIDS[grid][2]},")
    shape = tuple(len(t.lam) for t in rs.tr)
    rhs = np.random.default_rng(len(grid)).standard_normal(shape)
    rhs -= rhs.mean()
    want = np.asarray(rs.solve(jnp.asarray(rhs)))
    got, stats = ts.solve_with_stats(torch.from_numpy(rhs.copy()))
    err = (np.linalg.norm(got.numpy() - want)
           / max(np.linalg.norm(want), 1e-300))
    assert err <= 1e-11, err
    assert stats.status == "DIRECT" and stats.rel_residual < 1e-12
    _, rstats = rs.solve_with_stats(jnp.asarray(rhs))
    assert abs(stats.rel_residual - float(rstats.rel_residual)) < 1e-12


def test_pallas_solve_launch_sequence():
    """The all-periodic solve runs four passes and one modal pass, the
    channel's two passes and one modal pass (on the CPU the wrappers count
    no launch: the count is of kernel launches); both solves equal the
    dense-eigenbasis solve ("matmul") to 1e-11."""
    calls = []
    orig = K._fht_pass_launch, K._fht_modal_launch

    def spy_pass(f, *, axis, t, inverse):
        calls.append(("pass", axis, inverse))
        return orig[0](f, axis=axis, t=t, inverse=inverse)

    def spy_modal(f, la, lr, *, axis, **kw):
        calls.append(("modal", axis))
        return orig[1](f, la, lr, axis=axis, **kw)

    K._fht_pass_launch, K._fht_modal_launch = spy_pass, spy_modal
    try:
        for grid, seq in (("periodic64", [("pass", 0, False),
                                          ("pass", 1, False), ("modal", 2),
                                          ("pass", 1, True),
                                          ("pass", 0, True)]),
                          ("wall64", [("pass", 0, False), ("modal", 2),
                                      ("pass", 0, True)])):
            _, ts = _solver_pair(grid, "pallas_fft")
            _, dense = _solver_pair(grid, "matmul")
            rhs = torch.from_numpy(_data((64, 64, 64), 1))
            calls.clear()
            got = ts.solve(rhs)
            assert calls == seq
            assert _rel(got.numpy(), dense.solve(rhs).numpy()) <= 1e-11
    finally:
        K._fht_pass_launch, K._fht_modal_launch = orig
    assert K.fht_pass.launches == K.fht_modal.launches == 0


@pytest.mark.parametrize("prec,bound", [("high", 1e-3), ("highest", 5e-5)])
def test_float32_tiers_hold_reference_bounds(prec, bound):
    """Float32 solves at both precision tiers stay under the reference's
    residual bounds (test_pallas_fht.py:130-149); the port computes both
    in float32, so both meet the HIGHEST tier's 5e-5."""
    n = 64
    rhs = np.random.default_rng(1).standard_normal((n, n, n)).astype(
        np.float32)
    rhs -= rhs.mean()
    mesh, cfg = _mk(T, n, "periodic", "float32",
                    poisson_matmul_precision=prec)
    s = TFDM(mesh, cfg, transform="pallas_fft", device="cpu")
    p, st = s.solve_with_stats(torch.from_numpy(rhs))
    assert p.dtype == torch.float32
    assert st.rel_residual < min(bound, 5e-5), st.rel_residual


def test_null_mode_pinned():
    """A constant added to the rhs changes nothing: the solve is
    mean-free with no mean subtraction."""
    mesh, cfg = _mk(T, 64, "periodic")
    s = TFDM(mesh, cfg, transform="pallas_fft", device="cpu")
    rhs = _data((64, 64, 64), 2)
    rhs -= rhs.mean()
    p1 = s.solve(torch.from_numpy(rhs))
    p2 = s.solve(torch.from_numpy(rhs + 3.7))
    assert abs(float(p1.mean())) < 1e-12
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

KEYS = ("u", "v", "w", "p")
TRAJ = {
    # x and z take the Hartley kernels (64 = 1 x 64), y the dense basis
    "tgv": dict(Nx=64, Ny=16, Nz=64, bc_x="periodic", bc_y="periodic",
                bc_z="periodic", y_min=0.0, y_max=2 * np.pi,
                z_max=2 * np.pi, dp_dx=0.0, convective_scheme="skew"),
    "channel": dict(Nx=64, Ny=24, Nz=64, stretch_y=True, z_max=1.0,
                    dp_dx=-1e-3),
}


def _cfg(pkg, **kw):
    k = dict(dict(nu=1e-3, nu_specified=True, dp_dx_specified=True,
                  dt=1e-3, adaptive_dt=False, dtype="float64"), **kw)
    for name, enum_ in (("bc_x", pkg.BCType), ("bc_y", pkg.BCType),
                        ("bc_z", pkg.BCType),
                        ("convective_scheme", pkg.ConvectiveScheme)):
        if name in k:
            k[name] = enum_(k[name])
    return pkg.Config(**k)


@pytest.mark.parametrize("case", sorted(TRAJ))
def test_trajectory_matches_reference(case):
    """5 Euler steps with poisson_transform="pallas_fft" (the port's
    kernels' twins, use_pallas="on"; the reference's operators and
    interpret-mode Hartley kernels) to 1e-11 of each field's scale."""
    kw = dict(TRAJ[case], poisson_transform="pallas_fft")
    rs = R.Simulation(_cfg(R, **kw, use_pallas="off"))
    ts = T.Simulation(_cfg(T, **kw, use_pallas="on"), device="cpu")
    assert ts.poisson.fht_axes == rs.poisson.fht_axes == (0, 2)
    r = (R.init_taylor_green(rs.cfg, rs.mesh) if case == "tgv"
         else R.perturbed_channel(rs.cfg, rs.mesh, amp=0.05))
    t = T.state_from_numpy(
        {k: np.asarray(getattr(r, k)) for k in KEYS + (
            "t", "step", "dt_prev", "t_comp") if getattr(r, k) is not None},
        "cpu", torch.float64)
    for _ in range(5):
        r, rd = rs.step(r)
        t, td = ts.step(t)
    out = T.state_to_numpy(t)
    for key in KEYS:
        want = np.asarray(getattr(r, key))
        np.testing.assert_allclose(out[key], want, rtol=0,
                                   atol=1e-11 * np.max(np.abs(want)),
                                   err_msg=key)
    assert float(td.div_linf) < 1e-10


@pytest.mark.parametrize("transform", ["fht", "pallas_fft"])
def test_simulation_runs_with_hartley_transform(transform):
    """A Simulation with either Hartley transform builds and steps (the
    port raised for both before); the step equals the "fft" step to
    1e-11."""
    kw = dict(TRAJ["channel"], poisson_transform=transform)
    ts = T.Simulation(_cfg(T, **kw), device="cpu")
    ref = T.Simulation(_cfg(T, **dict(kw, poisson_transform="fft")),
                       device="cpu")
    assert ts.poisson.fht_axes == (0, 2) and ref.poisson.fft_axes == (0, 2)
    gen = torch.Generator().manual_seed(0)
    st = T.perturbed_channel(ts.cfg, ts.mesh, gen, amp=0.05, device="cpu")
    a, _ = ts.run(st, 2)
    b, _ = ref.run(st, 2)
    for key in KEYS:
        x, y = getattr(a, key), getattr(b, key)
        assert _rel(x.numpy(), y.numpy()) <= 1e-11, key


def test_poisson_diagnostics_print_the_residual(capfd):
    """CFDNN_POISSON_DIAGNOSTICS set when a Simulation is built (it is
    read once, there): each solve prints its status and relative
    residual, as the reference's env-gated print."""
    os.environ["CFDNN_POISSON_DIAGNOSTICS"] = "1"
    try:
        ts = T.Simulation(_cfg(T, **dict(TRAJ["tgv"], Nx=16, Nz=16)),
                          device="cpu")
    finally:
        os.environ.pop("CFDNN_POISSON_DIAGNOSTICS")
    ts.step(T.init_taylor_green(ts.cfg, ts.mesh, device="cpu"))
    line = capfd.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[poisson] DIRECT rel_residual=")
    assert float(line.split("=")[1]) < 1e-12


@pytest.mark.parametrize("which", ["fht_pass", "fht_modal"])
def test_backward_raises(which):
    """A gradient through either wrapper raises (the reference has no AD
    rule for its Hartley kernels); without one the output carries none."""
    t = tp.PFHTAxis.make(64, torch.float64, device="cpu")
    x = torch.from_numpy(_data((64, 4, 8), 3))
    args = ((torch.zeros(64, dtype=torch.float64),
             -torch.ones((4, 8), dtype=torch.float64)) if which == "fht_modal"
            else ())
    kw = dict(thr=1e-9, norm=1.0 / 64) if which == "fht_modal" else {}
    fn = getattr(K, which)
    assert not fn(x, 0, t, *args, **kw).requires_grad
    y = fn(x.clone().requires_grad_(True), 0, t, *args, **kw)
    with pytest.raises(RuntimeError, match="no gradient"):
        y.sum().backward()


def test_wrappers_refuse_what_they_do_not_take():
    """Wrong axis length, a 2-D tensor, mixed dtypes, a non-contiguous
    tensor and a wrong lam_rest shape raise before any launch."""
    t = tp.PFHTAxis.make(64, torch.float64, device="cpu")
    x = torch.zeros((64, 4, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="length"):
        K.fht_pass(x, 1, t)
    with pytest.raises(ValueError, match="3-D"):
        K.fht_pass(x[0], 0, t)
    with pytest.raises(TypeError, match="mixed dtypes"):
        K.fht_pass(x.float(), 0, t)
    with pytest.raises(ValueError, match="contiguous"):
        K.fht_pass(torch.zeros((4, 64, 8), dtype=torch.float64)
                   .transpose(0, 1), 0, t)
    with pytest.raises(ValueError, match="shape"):
        K.fht_modal(x, 0, t, torch.zeros(64, dtype=torch.float64),
                    torch.zeros((8, 4), dtype=torch.float64), thr=0.0,
                    norm=1.0)


def test_bench_configs_are_the_512_rows():
    """tgv512 and channel512 are bench.py's bench_tgv(512) and
    bench_channel(512) (bench.py:57-88: dt 1e-4 and 5e-5 above 128), with
    the transform left at "auto"; the _pfht rows are the same with
    poisson_transform="pallas_fft"."""
    for base, dt in ((bench.tgv_config, 1e-4), (bench.channel_config, 5e-5)):
        cfg = base(512).finalize()
        assert (cfg.Nx, cfg.Ny, cfg.Nz, cfg.dt, cfg.dtype) == (
            512, 512, 512, dt, "float32")
        assert cfg.benchmark and cfg.poisson_transform == "auto"
        assert base(512, poisson_transform="pallas_fft").finalize() == (
            dataclasses.replace(cfg, poisson_transform="pallas_fft"))


@pytest.mark.cuda
def test_kernels_match_twins_float64_on_cuda():
    """Both Hartley kernels against their twins on the card, float64, for
    every split and axis of chip_smoke._fht_cases, each output to 1e-12 *
    max|twin output|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    for case in chip_smoke._fht_cases(torch.float64, dev, 0):
        got, ref = case.kern(), case.twin()
        for out, err, lim, _ in chip_smoke.compare(case.name, got, ref,
                                                   torch.float64):
            assert err <= lim, f"{case.label} {out}: {err} > {lim}"
