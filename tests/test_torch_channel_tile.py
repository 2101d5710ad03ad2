"""The two slab kernels that walk an (x, z) tile along y: predictor_channel
(csrc/predictor_channel_tile.cuh) and correct (csrc/correct.cu).

On the CPU: the launch plan (csrc/tile_plan.cu, built by the host's C++
compiler: the chunk of y planes a block walks, here and in the two other
walked tiles, predictor_periodic's and divergence's, at least two waves of
blocks and at least eight planes; `tile_refusal`: the grids the tile
refuses, and the wrappers' ValueError naming the gate), and the wrappers
(their twins here) against the JAX
reference on the shapes where the tile can break: predictor_channel at
nx = 8 with ny = 2 and 3 and on a ragged 12 x 20 x 40, against
`fused_predictor_channel` in interpret mode; correct on the periodic box,
the duct, a wall-x cavity, a 2-D channel and an nx = 5 channel, against
the reference's operators (and `fused_correct` in interpret mode where
its periodic-x slab serves), float64 to 1e-12.

On a CUDA card (`cuda`): each kernel against its twin on chip_smoke's edge
shapes (`_tile_cases`), float64 to 1e-14 and float32 to 1e-5 of each
output's scale, and the library's chunk rule against the host's build.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import operators as rops
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu_torch.ops import kernels as K

ATOL = 1e-12
H100_SMS = 132
TILE_X, TILE_Z = 8, 32     # the (x, z) tile of both kernels
CHUNK_MIN, CHUNK_MAX, MAX_CHUNKS = 8, 64, 65535


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


def _fields(sim, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in T.velocity_shapes(sim.cfg)]


def _t(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def _close(got, want, what=""):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def rule(tmp_path_factory):
    """cfdnn_tile_chunk of csrc/tile_plan.cu (plain C++), built by the
    host's C++ compiler."""
    lib = tmp_path_factory.mktemp("tile_plan") / "libtile_plan.so"
    subprocess.run([shutil.which("g++") or "c++", "-x", "c++", "-std=c++17",
                    "-shared", "-fPIC", "-o", str(lib),
                    str(K._CSRC / "tile_plan.cu")], check=True)
    fn = ctypes.CDLL(str(lib)).cfdnn_tile_chunk
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _tiles(nx, nz):
    return -(-nx // TILE_X) * -(-nz // TILE_Z)


# (nx, rows walked, nz, the blocks an H100 holds at once, the chunk): the
# main paths' grids (channel 128^3, les_channel 128x64x128, les_ibm256
# 256x128x256, channel512, tgv512; the predictor walks ny + 1 planes, four
# blocks an SM in float32 and two in float64; correct eight), then those of
# the periodic predictor (csrc/predictor_periodic_tile.cuh: ny planes, four
# blocks an SM, or six as its 40 registers allow in float32: the same
# chunks; tgv 128^3 and 512^3, a grid below the tile's width) and of
# divergence (csrc/divergence.cu: six blocks an SM; tgv 128^3, les_ibm256)
PLANS = [(128, 129, 128, 4 * H100_SMS, 8),
         (128, 65, 128, 4 * H100_SMS, 8),
         (256, 129, 256, 4 * H100_SMS, 31),
         (512, 513, 512, 4 * H100_SMS, 64),
         (128, 129, 128, 2 * H100_SMS, 15),
         (128, 128, 128, 8 * H100_SMS, 8),
         (256, 128, 256, 8 * H100_SMS, 15),
         (512, 512, 512, 8 * H100_SMS, 64),
         (128, 128, 128, 4 * H100_SMS, 8),
         (512, 512, 512, 4 * H100_SMS, 64),
         (5, 20, 33, 4 * H100_SMS, 8),
         (128, 128, 128, 6 * H100_SMS, 8),
         (256, 128, 256, 6 * H100_SMS, 20)]


@pytest.mark.parametrize("nx,rows,nz,resident,want", PLANS)
def test_tile_chunk_gives_two_waves_of_at_least_eight_planes(
        rule, nx, rows, nz, resident, want):
    tiles = _tiles(nx, nz)
    chunk = rule(tiles, rows, resident)
    assert chunk == want
    assert CHUNK_MIN <= chunk <= CHUNK_MAX
    if chunk > CHUNK_MIN:
        # long enough chunks only while the blocks still make two waves
        assert tiles * -(-rows // chunk) >= 2 * resident
    if CHUNK_MIN < chunk < CHUNK_MAX:
        # ... and the longest such: one plane more would fall short
        assert tiles * rows < 2 * resident * (chunk + 1)


def test_tile_chunk_keeps_the_chunks_within_the_launch_grid(rule):
    rows = 3 * MAX_CHUNKS * CHUNK_MIN
    chunk = rule(1, rows, 300000)
    assert chunk >= CHUNK_MIN
    assert -(-rows // chunk) <= MAX_CHUNKS
    # and a kernel the card cannot hold at all still gets a chunk
    assert rule(_tiles(128, 128), 129, 0) == CHUNK_MAX


def test_predictor_channel_refuses_nx_below_the_tile():
    """nx < 8: the tile stages its x halo with one periodic wrap, so the
    wrapper raises ValueError naming that gate (the solver's plan never
    sends such a grid: tiling_mode needs x.n >= 8)."""
    _, ts = _sims(Nx=4, Ny=6, Nz=8, z_max=1.0)
    u, v, w = _t(_fields(ts, 0))
    dt = torch.tensor(1e-3, dtype=torch.float64)
    with pytest.raises(ValueError, match=r"needs nx >= 8 .*xz::fits.*nx = 4"):
        K.predictor_channel(u, v, w, dt, K.channel_y_arrays(ts.geom),
                            hx=ts.geom.x.h, hz=ts.geom.z.h, nu=1e-3, fx=0.0,
                            scheme=T.ConvectiveScheme.CENTRAL)
    assert T.solver.tiling_mode(ts.geom, ts.cfg) is None


def test_tile_refusal_names_the_offset_gate():
    assert K.tile_refusal("correct", 5, 5 * 20 * 33) is None
    why = K.tile_refusal("correct", 2048, 2048 * 1025 * 1024)
    assert "32-bit" in why and "2^31 - 1" in why
    assert K.tile_refusal("predictor_channel", 8, 8 * 21 * 6,
                          min_nx=8) is None


# the predictor's edge shapes: the smallest x the tile takes with every
# plane next to a wall (ny = 2, 3), and a ragged tile over several chunks
EDGE_CHANNELS = [dict(Nx=8, Ny=2, Nz=6), dict(Nx=8, Ny=3, Nz=6),
                 dict(Nx=12, Ny=20, Nz=40)]


@pytest.mark.parametrize("with_nut", [False, True])
@pytest.mark.parametrize("scheme", ["skew", "central"])
@pytest.mark.parametrize("grid", range(len(EDGE_CHANNELS)))
def test_predictor_channel_edge_shapes_match_pallas(grid, scheme, with_nut):
    rs, ts = _sims(**EDGE_CHANNELS[grid], z_max=1.0, stretch_y=True,
                   convective_scheme=scheme)
    assert K.channel_slab_eligible(ts.geom, ts.cfg)
    arrs = _fields(ts, 11)
    nut = (np.abs(np.random.default_rng(12).standard_normal(
        (ts.cfg.Nx, ts.cfg.Ny, ts.cfg.Nz))) * 1e-2 if with_nut else None)
    fx = float(-rs.cfg.dp_dx / rs.cfg.rho)
    want = PK.fused_predictor_channel(
        *(jnp.asarray(a) for a in arrs), 1e-3, geom=rs.geom, nu=rs.cfg.nu,
        fx=fx, scheme=rs.cfg.convective_scheme,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    got = K.predictor_channel(
        *_t(arrs), dt, K.channel_y_arrays(ts.geom), hx=ts.geom.x.h,
        hz=ts.geom.z.h, nu=ts.cfg.nu, fx=fx, scheme=ts.cfg.convective_scheme,
        nu_t=None if nut is None else torch.from_numpy(nut))
    _close(got, want, f"{EDGE_CHANNELS[grid]} {scheme} nu_t={with_nut}")


# correct's geometries: every mix of axis modes the wrapper takes
CORRECT_GRIDS = {
    "periodic": dict(Nx=12, Ny=20, Nz=40, bc_y="periodic", y_min=0.0,
                     y_max=1.0),
    "duct": dict(Nx=12, Ny=20, Nz=24, stretch_y=True, bc_z="wall",
                 z_min=-1.0),
    "wall-x": dict(Nx=10, Ny=18, Nz=16, bc_x="wall"),
    "2-D": dict(Nx=24, Ny=20, Nz=1, stretch_y=True),
    "nx5": dict(Nx=5, Ny=20, Nz=33, stretch_y=True),
}


@pytest.mark.parametrize("grid", sorted(CORRECT_GRIDS))
def test_correct_geometries_match_reference(grid):
    rs, ts = _sims(**CORRECT_GRIDS[grid])
    arrs = _fields(ts, 13)
    p = np.random.default_rng(14).standard_normal(
        (ts.cfg.Nx, ts.cfg.Ny, ts.cfg.Nz))
    ja = [jnp.asarray(a) for a in arrs]
    want = rops.correct_velocity(ja, jnp.asarray(p), 1e-3, rs.geom)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    got = K.correct(*_t(arrs), torch.from_numpy(p.copy()), dt, geom=ts.geom)
    _close(got, want, grid)
    if rs.geom.axes[0].periodic and ts.cfg.Nz > 1:
        _close(got, PK.fused_correct(*ja, jnp.asarray(p), 1e-3,
                                     geom=rs.geom, interpret=True), grid)


@pytest.mark.cuda
def test_tile_kernels_match_twins_on_cuda():
    """On a CUDA card: predictor_channel and correct against their twins
    on the tile's edge shapes (chip_smoke._tile_cases), float64 to 1e-14
    and float32 to 1e-5 of each output's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    for dtype in (torch.float64, torch.float32):
        for case in chip_smoke._tile_cases(dtype, dev, seed=4):
            got, ref = case.kern(), case.twin()
            for out, err, lim, _ in chip_smoke.compare(
                    case.name, got, ref, dtype, case.f64_tol):
                assert err <= lim, f"{case.label} {out} {dtype}: {err}"


@pytest.mark.cuda
def test_tile_chunk_rule_of_the_library_matches_the_host_build(rule):
    """On a CUDA card: the library's exported chunk rule (nvcc's build of
    csrc/tile_plan.cu) gives what the host compiler's build gives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the library is built by nvcc")
    lib = K.library()
    for nx, rows, nz, resident, _ in PLANS:
        tiles = _tiles(nx, nz)
        assert (lib.cfdnn_tile_chunk(tiles, rows, resident)
                == rule(tiles, rows, resident))
