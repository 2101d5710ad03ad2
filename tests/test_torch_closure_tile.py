"""The two closure kernels redesigned onto a walked (x, z) tile: nu_sgs
(csrc/nu_sgs_tile.cuh, on xz_tile.cuh's staged window with each field's own
rows and columns) and transport (csrc/transport_tile.cuh, SST's per-point
coefficients formed once a point into a ring of planes).

On the CPU: the wrappers (their twins here) against the JAX reference on
the shapes where the tiles can break, float64 to 1e-12 of each output's
scale: nu_sgs (each closure) against `fused_nu_sgs` in interpret mode, and
transport (each model) against `fused_transport_advance` in interpret
mode (its math_fn on whole arrays where SST's two-plane halo cannot tile
an odd nx), on stretched walled-y and periodic-y grids at nx = 8 with
ny = 2 and 3 and nz = 6 (< 32), a ragged 12 x 20 x 40, nx = 5 and 3 (the
staged x wrapped more than once) and a 16 x 12 x 20 duct (walled z),
transport also
on the channel with dp/dx = 0 (the omega pin on the wall cells only) and
the all-periodic box; both wrappers' 32-bit offset gate (ValueError naming
it); the chunk of y planes the two launchers walk (csrc/tile_plan.cu,
built by the host's C++ compiler); and 4 steps of a ragged RANS channel
(SST) and of a ragged LES duct (WALE) through the wrappers against the
reference's Pallas path in interpret mode.

On a CUDA card (`cuda`): both kernels against their twins on chip_smoke's
edge shapes (`_closure_tile_cases`), float64 to 1e-14 and float32 to 1e-5
of each output's scale.
"""

import ctypes
import functools
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu.turbulence import transport as rtr
from cfdnn_tpu_torch.ops import kernels as K
from cfdnn_tpu_torch.solver import KernelPlan

RTOL = 1e-12    # of each output's scale
CLOSURES = ("smagorinsky", "wale", "vreman")
H100_SMS = 132
# the tiles' edge shapes: overrides of a stretched walled-y channel
GRIDS = {
    "8x2x6": dict(Nx=8, Ny=2, Nz=6),
    "8x3x6": dict(Nx=8, Ny=3, Nz=6),
    "periodic-8x2x6": dict(Nx=8, Ny=2, Nz=6, bc_y="periodic"),
    "periodic-8x3x6": dict(Nx=8, Ny=3, Nz=6, bc_y="periodic"),
    "ragged-12x20x40": dict(Nx=12, Ny=20, Nz=40),
    "nx5-5x20x33": dict(Nx=5, Ny=20, Nz=33),
    "nx3-periodic-3x9x40": dict(Nx=3, Ny=9, Nz=40, bc_y="periodic"),
    "duct-16x12x20": dict(Nx=16, Ny=12, Nz=20, bc_z="wall", stretch_z=True),
}
# and transport's two more: the omega pin on the wall cells only, no wall
TRANSPORT_GRIDS = dict(GRIDS, **{
    "walls-pin-12x20x40": dict(Nx=12, Ny=20, Nz=40, dp_dx=0.0),
    "box-12x20x40": dict(Nx=12, Ny=20, Nz=40, bc_y="periodic",
                         bc_z="periodic"),
})


def _cfg(pkg, **kw):
    k = dict(nu=1e-3, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
             dt=1e-3, adaptive_dt=False, dtype="float64", stretch_y=True,
             y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0)
    k.update(kw)
    for axis in ("y", "z"):
        if k.get("bc_" + axis) == "periodic":
            k["stretch_" + axis] = False
    for name in ("bc_x", "bc_y", "bc_z"):
        if name in k:
            k[name] = pkg.BCType(k[name])
    for name, enum_ in (("turb_model", pkg.TurbulenceModel),
                        ("convective_scheme", pkg.ConvectiveScheme)):
        if name in k:
            k[name] = enum_(k[name])
    return pkg.Config(**k)


def _sims(**kw):
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
    return vel, [k, om, nut]


def _t(arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=RTOL * scale, err_msg=what)


@pytest.mark.parametrize("closure", CLOSURES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_nu_sgs_edge_shapes_match_pallas(grid, closure):
    rs, ts = _sims(**GRIDS[grid], turb_model=closure)
    assert K.nu_sgs_eligible(ts.geom)
    vel, _ = _fields(ts, 31)
    want = PK.fused_nu_sgs(*_j(vel), geom=rs.geom,
                           model_fn=rs.turb._model_fn, interpret=True)
    got = K.nu_sgs(*_t(vel), K.les_arrays(ts.geom), geom=ts.geom,
                   closure=closure, coeff=ts.turb.coeff)
    _close(got, want, f"{grid} {closure}")


@pytest.mark.parametrize("model", sorted(K.TRANSPORT_MODELS))
@pytest.mark.parametrize("grid", sorted(TRANSPORT_GRIDS))
def test_transport_edge_shapes_match_pallas(grid, model):
    kind = "komega" if model == "komega" else "sst"
    rs, ts = _sims(**TRANSPORT_GRIDS[grid], turb_model=kind)
    vel, cell = _fields(ts, 32)
    rt, tt = rs.turb, ts.turb
    if model == "komega":
        form, n_out, ng = rtr._komega_math_kernel_form, 2, 1
        consts, extra = [rt.y_wall], dict(skip_y=False)
    elif model == "sst":
        form, n_out, ng = rtr._sst_math_kernel_form, 2, 2
        consts, extra = [rt.y_wall], dict(skip_y=False)
    else:
        form, n_out, ng = rtr._sst_math_with_nut_kernel_form, 3, 2
        consts, extra = [rt.y_wall], dict(has_wall=tt.has_wall)
        if tt.has_wall:
            consts += [rt.om_pin_mask.astype(jnp.float64), rt.om_visc]
    math_fn = functools.partial(form, nu=rs.cfg.nu, c=rt.c,
                                om_wall=tt.om_wall, **extra)
    consts = [jnp.broadcast_to(a, (1,) + cell[0].shape[1:]) for a in consts]
    if ng == 2 and ts.cfg.Nx % 2:
        # the reference's slab cannot tile an odd Nx into SST's two-plane
        # halo blocks: its math_fn on the whole arrays, which the slab
        # kernel runs on each block
        want = math_fn(_j(vel), *_j(cell), rs.geom, consts, 1e-3)
    else:
        want = PK.fused_transport_advance(
            *_j(vel), *_j(cell), 1e-3, geom=rs.geom, math_fn=math_fn,
            consts=consts, n_out=n_out, ng=ng, interpret=True)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    got = K.transport(*_t(vel), *_t(cell), dt, tt.kernel_consts,
                      K.transport_arrays(ts.geom), geom=ts.geom, model=model,
                      c=tt.c, nu=ts.cfg.nu, om_wall=tt.om_wall)
    assert len(got) == n_out
    for name, g, w in zip(("k", "omega", "nu_t"), got, want):
        _close(g, w, f"{grid} {model} {name}")


def test_wrappers_refuse_offsets_past_32_bits(monkeypatch):
    """Both tiles index with 32-bit offsets: a field past INT32_MAX
    elements raises ValueError naming the gate (here with the limit
    lowered, so that a small grid reaches it), on the CPU as on the card;
    the limit counts the largest face array (v's ny + 1 rows of a walled
    y). Both take every nx (no x gate)."""
    _, ts = _sims(Nx=5, Ny=6, Nz=8, turb_model="sst")
    vel, cell = _fields(ts, 33)
    u, v, w = _t(vel)
    g = ts.geom
    les = dict(geom=g, closure="smagorinsky", coeff=0.17)
    tt = ts.turb
    trans = dict(geom=g, model="sst_nut", c=tt.c, nu=ts.cfg.nu,
                 om_wall=tt.om_wall)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    args = (u, v, w, *_t(cell), dt, tt.kernel_consts, K.transport_arrays(g))
    largest = 5 * 7 * 8    # v: (Nx, Ny + 1, Nz)
    monkeypatch.setattr(K, "INT32_MAX", largest)
    K.nu_sgs(u, v, w, K.les_arrays(g), **les)
    K.transport(*args, **trans)
    monkeypatch.setattr(K, "INT32_MAX", largest - 1)
    with pytest.raises(ValueError, match=r"nu_sgs: .*32-bit.*2\^31 - 1"):
        K.nu_sgs(u, v, w, K.les_arrays(g), **les)
    with pytest.raises(ValueError, match=r"transport: .*32-bit.*2\^31 - 1"):
        K.transport(*args, **trans)


@pytest.fixture(scope="module")
def rule(tmp_path_factory):
    """cfdnn_tile_chunk of csrc/tile_plan.cu (plain C++), built by the
    host's C++ compiler: the rule both launchers take through
    cfdnn::walk_chunk."""
    lib = tmp_path_factory.mktemp("tile_plan") / "libtile_plan.so"
    subprocess.run([shutil.which("g++") or "c++", "-x", "c++", "-std=c++17",
                    "-shared", "-fPIC", "-o", str(lib),
                    str(K._CSRC / "tile_plan.cu")], check=True)
    fn = ctypes.CDLL(str(lib)).cfdnn_tile_chunk
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


# (nx, ny, nz, the blocks an H100 holds at once, the chunk): both kernels
# run four blocks an SM in float32 (64 registers): transport at
# rans_channel's 128^3 (eight planes, the least), nu_sgs at les_ibm256's
# 256x128x256 and at les_channel's 128x64x128; and at two and six blocks
# an SM; both walk ny planes of 8 x 32 tiles
CLOSURE_PLANS = [(128, 128, 128, 4 * H100_SMS, 8),
                 (256, 128, 256, 4 * H100_SMS, 31),
                 (128, 64, 128, 4 * H100_SMS, 8),
                 (128, 128, 128, 2 * H100_SMS, 15),
                 (256, 128, 256, 6 * H100_SMS, 20)]


@pytest.mark.parametrize("plan", CLOSURE_PLANS,
                         ids=["x".join(map(str, p[:3])) + f"@{p[3]}"
                              for p in CLOSURE_PLANS])
def test_closure_launchers_chunk_plan(rule, plan):
    nx, ny, nz, resident, want = plan
    tiles = -(-nx // 8) * -(-nz // 32)
    chunk = rule(tiles, ny, resident)
    assert chunk == want
    blocks = tiles * -(-ny // chunk)
    assert blocks >= 2 * resident or chunk == 8


def _trajectory(base, keys, plan, steps=4):
    """`steps` steps of the reference (use_pallas="on": its Pallas kernels
    in interpret mode) and of the port (the wrappers' twins on the CPU)
    from the reference's initialize(perturbed_channel); each key to 1e-12
    of its scale."""
    rsim, tsim = _sims(**base, use_pallas="on")
    assert tsim.kernels == plan
    assert rsim._pallas_predictor_ok == "slab"
    r = rsim.initialize(R.perturbed_channel(rsim.cfg, rsim.mesh, amp=0.05))
    t = T.state_from_numpy(
        {k: np.asarray(getattr(r, k)) for k in
         ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "k",
          "omega", "nu_t") if getattr(r, k) is not None},
        "cpu", torch.float64)
    for _ in range(steps):
        r, _ = rsim.step(r)
        t, td = tsim.step(t)
    out = T.state_to_numpy(t)
    for key in keys:
        want = np.asarray(getattr(r, key))
        scale = max(float(np.max(np.abs(want))), 1e-300)
        np.testing.assert_allclose(out[key], want, rtol=0,
                                   atol=RTOL * scale, err_msg=key)
    assert float(td.div_linf) < 1e-10
    return out


def test_ragged_rans_channel_through_transport_matches_reference():
    """4 SST steps of a stretched 12x20x40 channel (neither x nor z a
    multiple of the 8 x 32 tile) through the transport wrapper against the
    reference's fused_transport_advance in interpret mode."""
    out = _trajectory(dict(Nx=12, Ny=20, Nz=40, turb_model="sst"),
                      ("u", "v", "w", "p", "k", "omega", "nu_t"),
                      KernelPlan("channel", "slab", "transport"))
    assert float(np.min(out["k"])) > 0 and float(np.min(out["omega"])) > 0


def test_ragged_les_duct_through_nu_sgs_matches_reference():
    """4 WALE steps of a 12x20x40 duct (walled y and z, central) through
    the nu_sgs wrapper against the reference's fused_nu_sgs in interpret
    mode."""
    out = _trajectory(dict(Nx=12, Ny=20, Nz=40, bc_z="wall", stretch_z=True,
                           convective_scheme="central", turb_model="wale"),
                      ("u", "v", "w", "p", "nu_t"),
                      KernelPlan("general", "slab", "nu_sgs"))
    assert float(np.min(out["nu_t"])) >= 0 and float(np.max(out["nu_t"])) > 0


@pytest.mark.cuda
def test_closure_tile_kernels_match_twins_on_cuda():
    """On a CUDA card: nu_sgs and transport against their twins on the
    tiles' edge shapes (chip_smoke._closure_tile_cases), float64 to 1e-14
    and float32 to 1e-5 of each output's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    for dtype in (torch.float64, torch.float32):
        cases = chip_smoke._closure_tile_cases(dtype, dev, seed=5)
        assert len(cases) == 66
        for case in cases:
            got, ref = case.kern(), case.twin()
            for out, err, lim, _ in chip_smoke.compare(
                    case.name, got, ref, dtype, case.f64_tol):
                assert err <= lim, f"{case.label} {out} {dtype}: {err}"
