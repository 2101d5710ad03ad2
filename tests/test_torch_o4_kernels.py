"""The O4 (space_order=4) predictor_general, divergence and correct
wrappers of the port (their twins on the CPU) against the JAX package's
fused_predictor_general, fused_divergence and fused_correct in interpret
mode, whose x slabs of bx = 2, 4 and 8 cells carry a two-cell halo at O4,
at float64 to 1e-12; on a CUDA card, the three O4 kernels against their
twins on chip_smoke's O4 cases. (tests/test_torch_o4.py holds the rest of
O4.)
"""

import jax.numpy as jnp
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.ops import operators as rops
from cfdnn_tpu.ops import pallas_kernels as PK
from cfdnn_tpu_torch.ops import kernels as K
from test_torch_o4 import GRIDS, _cfg, _close, _geoms, _inputs, _t

# (grid, scheme, with nu_t, bx)
PREDICTOR_CASES = (
    ("box16", "skew", False, 2), ("box16", "central", False, 4),
    ("box16", "skew", True, 8), ("box16", "central", True, 2),
    ("channel", "central", False, 8), ("box_n3_n4", "central", False, 4),
)


@pytest.mark.parametrize("grid,scheme,with_nut,bx", PREDICTOR_CASES)
def test_predictor_general_matches_pallas(grid, scheme, with_nut, bx):
    """predictor_general (its twin on the CPU) at O4 against the
    reference's fused_predictor_general in interpret mode (x slabs of bx
    cells with a two-cell halo), to 1e-12."""
    kw = dict(GRIDS[grid][0], convective_scheme=scheme)
    rs = R.Simulation(_cfg(R, **kw))
    ts = T.Simulation(_cfg(T, **kw), device="cpu")
    assert K.general_eligible(ts.geom, ts.cfg)
    comps, _, nut = _inputs(ts.cfg, seed=bx)
    nut = nut if with_nut else None
    dt, fx = 1e-2, 0.7
    want = PK.fused_predictor_general(
        *(jnp.asarray(c) for c in comps), dt, geom=rs.geom,
        scheme=rs.cfg.convective_scheme, nu=rs.cfg.nu, fx=fx, bx=bx,
        nu_t=None if nut is None else jnp.asarray(nut), interpret=True)
    got = K.predictor_general(
        *(_t(c) for c in comps), torch.tensor(dt, dtype=torch.float64),
        K.general_arrays(ts.geom), geom=ts.geom, nu=ts.cfg.nu, fx=fx,
        scheme=ts.cfg.convective_scheme,
        nu_t=None if nut is None else _t(nut))
    _close(got, want, f"{grid} {scheme} nu_t={with_nut} bx={bx}")


@pytest.mark.parametrize("bx", [2, 4, 8])
@pytest.mark.parametrize("grid", ["box16", "channel"])
def test_divergence_and_correct_match_pallas(grid, bx):
    """divergence and correct (their twins on the CPU) at O4 against the
    reference's fused_divergence and fused_correct in interpret mode, to
    1e-12; the reference's ops.divergence too."""
    rg, tg, cfg = _geoms(grid)
    comps, p, _ = _inputs(cfg, seed=bx)
    rc = tuple(jnp.asarray(c) for c in comps)
    tc = tuple(_t(c) for c in comps)
    want = PK.fused_divergence(*rc, geom=rg, bx=bx, interpret=True)
    _close(K.divergence(*tc, geom=tg), want, f"divergence bx={bx}")
    _close(K.divergence(*tc, geom=tg), rops.divergence(rc, rg), "ops")
    want = PK.fused_correct(*rc, jnp.asarray(p), 1e-3, geom=rg, bx=bx,
                            interpret=True)
    got = K.correct(*tc, _t(p), torch.tensor(1e-3, dtype=torch.float64),
                    geom=tg)
    _close(got, want, f"correct bx={bx}")


@pytest.mark.parametrize("symbol", [
    "_ZN56_GLOBAL__N__0c1d2e3f_23_predictor_general_o4_cu_a1b2c3d427"
    "predictor_general_o4_kernelIfLb0ELb0ELb0EEEvN5cfdnn7general4GridIT_E",
    "void (anonymous namespace)::predictor_general_o4_kernel<double, true, "
    "false, true>(x)",
    "_ZN46_GLOBAL__N__35a9c929_13_divergence_cu_27bdac6217divergence_"
    "kernelIfLb1EEEvPKT_S3_S3_S3_S3_S3_PS1_iiiiiii",
    "void (anonymous namespace)::correct_kernel<double, true>(double const*)",
])
def test_device_launches_names_the_o4_kernels(symbol):
    """A CUDA graph's node or a profiler record of an O4 kernel counts for
    its wrapper (predictor_general, divergence, correct), as the O2
    kernel's does."""
    name = ("predictor_general" if "predictor_general" in symbol
            else "divergence" if "divergence" in symbol else "correct")
    assert K.device_launches([(symbol, 3)]) == {name: 3}


@pytest.mark.cuda
def test_o4_kernels_match_twins_on_cuda():
    """On a CUDA card: the O4 variants of predictor_general, divergence
    and correct against their twins on chip_smoke's O4 cases
    (`_o4_cases`: the box, the stretched channel, the duct, nx = 8 with
    ny = 2, 3 and 4, the ragged 12x70x40, periodic axes of 4 and 5 cells),
    float64 to 1e-12 and float32 to 1e-5 of each output's scale, the
    predictor between NaN bands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    dev = torch.device("cuda", 0)
    errs = {}
    for dtype in (torch.float64, torch.float32):
        for case in chip_smoke._o4_cases(dtype, dev, seed=5):
            chip_smoke._hold(case, dtype, errs)
