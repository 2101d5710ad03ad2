"""The PyTorch port's Config and Mesh against the JAX reference's.

The port owns copies of config.py and mesh.py (importing the reference
would import JAX); these tests make any drift between the copies fail.
"""

import dataclasses
import enum

import numpy as np
import pytest

import cfdnn_tpu as ref
import cfdnn_tpu.mesh as ref_mesh
import cfdnn_tpu_torch as port
import cfdnn_tpu_torch.mesh as port_mesh


def _plain(cfg):
    """Config as a dict with enums as their values (the two packages'
    enums are distinct classes with equal values)."""
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(cfg).items()}


def test_config_fields_and_defaults_equal():
    rf = {f.name: f for f in dataclasses.fields(ref.Config)}
    pf = {f.name: f for f in dataclasses.fields(port.Config)}
    assert list(rf) == list(pf)
    for name in rf:
        assert str(rf[name].type) == str(pf[name].type), name
    assert _plain(ref.Config()) == _plain(port.Config())


def test_config_enums_equal():
    for name in ("TurbulenceModel", "ConvectiveScheme", "TimeIntegrator",
                 "PoissonSolverType", "SimulationMode", "BCType"):
        assert ([e.value for e in getattr(ref, name)]
                == [e.value for e in getattr(port, name)]), name


@pytest.mark.parametrize("argv", [
    ["--Nx", "32", "--Re", "180", "--benchmark"],
    ["--nu=0.002", "--dp_dx", "-0.5", "--convective_scheme", "skew",
     "--bc_y", "periodic", "--mesh_shape", "2,2", "--perf_mode"],
    ["--model", "sst", "--stretch_y", "--stretch_beta", "2.5"],
])
def test_config_parse_and_finalize_equal(argv):
    r = ref.Config().parse_args(argv).finalize()
    p = port.Config().parse_args(argv).finalize()
    assert _plain(r) == _plain(p)


def test_config_from_file_equal(tmp_path):
    path = tmp_path / "case.cfg"
    path.write_text("Nx = 48\nRe 395  # comment\ntime_integrator = rk3\n"
                    "use_pallas = off\n")
    assert (_plain(ref.Config.from_file(str(path)).finalize())
            == _plain(port.Config.from_file(str(path)).finalize()))


@pytest.mark.parametrize("stretch", [False, True])
def test_mesh_equal(stretch):
    """Exact for a uniform mesh; <= 1e-15 for a stretched one (the same
    NumPy code, so in practice also exact)."""
    kw = dict(Nx=16, Ny=24, Nz=8, stretch_y=stretch, stretch_z=stretch,
              stretch_beta=2.2)
    rm = ref_mesh.Mesh.from_config(ref.Config(**kw))
    pm = port_mesh.Mesh.from_config(port.Config(**kw))
    tol = 1e-15 if stretch else 0.0
    for a in "xyz":
        ra, pa = getattr(rm, a), getattr(pm, a)
        assert ra.n == pa.n and ra.uniform == pa.uniform
        for f in ("faces", "centers", "d", "dc"):
            np.testing.assert_allclose(getattr(pa, f), getattr(ra, f),
                                       rtol=0, atol=tol, err_msg=f"{a}.{f}")
        for periodic in (False, True):
            for r, p in zip(ra.laplacian_metrics(periodic),
                            pa.laplacian_metrics(periodic)):
                np.testing.assert_allclose(p, r, rtol=tol, atol=0)
    assert pm.ncells == rm.ncells
    np.testing.assert_array_equal(pm.wall_distance_y(), rm.wall_distance_y())
