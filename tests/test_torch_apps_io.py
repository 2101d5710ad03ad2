"""The port's apps (cfdnn_tpu_torch/apps: taylor_green_3d, channel, duct
through `main(argv)` with `--platform cpu`), its VTK writer and reader and
its checkpoints (cfdnn_tpu_torch/io) against the JAX reference's at
float64 on the CPU.

The apps run at the reference's own app tests' tiny sizes
(tests/test_apps_io.py), their QOIs to 1e-10 relative of the reference
app's; VTK files and profiles byte for byte the reference's; checkpoints
bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import cfdnn_tpu as R
import cfdnn_tpu_torch as T
from cfdnn_tpu.apps import channel as r_channel
from cfdnn_tpu.apps import duct as r_duct
from cfdnn_tpu.apps import taylor_green_3d as r_tgv
from cfdnn_tpu.io import vtk as r_vtk
from cfdnn_tpu_torch.apps import channel, duct, runner, taylor_green_3d
from cfdnn_tpu_torch.io import checkpoint, vtk

KEYS = ("u", "v", "w", "p", "t", "step", "dt_prev", "t_comp", "k", "omega",
        "nu_t")
COMMON = ["--max_steps", "30", "--output_freq", "10", "--num_snapshots",
          "0", "--verbose", "false", "--write_fields", "false",
          "--platform", "cpu"]
# (port app, reference app, arguments): the reference's app tests' grids,
# the Taylor-Green in float64
APPS = {
    "taylor_green_3d": (taylor_green_3d, r_tgv,
                        ["--Nx", "16", "--Ny", "16", "--Nz", "16",
                         "--dtype", "float64"]),
    "channel": (channel, r_channel, ["--Nx", "16", "--Ny", "32", "--tol",
                                     "0"]),
    "duct": (duct, r_duct, ["--Nx", "8", "--Ny", "16", "--Nz", "16",
                            "--tol", "0"]),
}


def _to_port(state):
    return T.state_from_numpy(
        {k: np.asarray(getattr(state, k)) for k in KEYS
         if getattr(state, k, None) is not None}, "cpu", torch.float64)


@pytest.mark.parametrize("app", sorted(APPS))
def test_app_matches_reference(app, tmp_path):
    """`main(argv)` of each app on the CPU: the same steps, its validation
    QOIs to 1e-10 relative of the reference app's, the final fields to
    1e-12 of their scale."""
    mod, ref, args = APPS[app]
    argv = args + COMMON + ["--output_dir", str(tmp_path) + "/"]
    sim, st, d = mod.main(argv)
    rsim, rst, rd = ref.main(argv)
    assert sim.device.type == "cpu" and int(st.step) == int(rst.step) == 30
    got, want = mod.validate(sim, st, d), ref.validate(rsim, rst, rd)
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "div_linf":
            # roundoff of a divergence-free field: both at machine zero
            assert abs(got[k] - float(w)) <= 1e-12
        else:
            np.testing.assert_allclose(got[k], float(w), rtol=1e-10,
                                       err_msg=k)
    for k in ("u", "v", "w", "p"):
        want_k = np.asarray(getattr(rst, k))
        np.testing.assert_allclose(
            getattr(st, k).numpy(), want_k, rtol=0,
            atol=1e-12 * float(np.max(np.abs(want_k))), err_msg=k)


def test_platform_selects_the_device(monkeypatch):
    """--platform "" / gpu / cuda takes the CUDA card and raises without
    one, cpu takes the CPU, tpu raises."""
    assert runner.select_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="tpu"):
        runner.select_device("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for p in ("", "gpu", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runner.select_device(p)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        channel.main(["--Nx", "8", "--Ny", "8", "--max_steps", "1",
                      "--verbose", "false", "--write_fields", "false"])


def _vtk_cases():
    """(name, config kwargs, state maker) of the VTK cases: a 3-D
    Taylor-Green box (binary), a 2-D Poiseuille channel (ASCII), a duct
    with stretched y and z (binary, both sidecars) and an SST channel
    (nu_t, k and omega scalars, the y sidecar)."""
    tgv = dict(Nx=8, Ny=8, Nz=8, bc_y="periodic", y_min=0.0,
               y_max=2 * np.pi, z_max=2 * np.pi)
    return {
        "tgv3d": (tgv, lambda pkg, c, m: pkg.init_taylor_green(c, m)),
        "poiseuille2d": (dict(Nx=8, Ny=8, Nz=1),
                         lambda pkg, c, m: pkg.init_poiseuille(c, m, 1.0)),
        "duct_stretched": (dict(Nx=8, Ny=12, Nz=16, bc_z="wall",
                                stretch_y=True, stretch_z=True),
                           lambda pkg, c, m: pkg.perturbed_channel(
                               c, m, amp=0.1)),
        "sst_channel": (dict(Nx=8, Ny=12, Nz=6, stretch_y=True,
                             turb_model="sst"),
                        lambda pkg, c, m: pkg.perturbed_channel(
                            c, m, amp=0.1)),
    }


def _vtk_pair(name):
    kw, make = _vtk_cases()[name]
    base = dict(nu=1e-3, nu_specified=True, dp_dx=-1e-3,
                dp_dx_specified=True, dtype="float64", **kw)
    rk, tk = dict(base), dict(base)
    for f, enum_ in (("bc_y", "BCType"), ("bc_z", "BCType"),
                     ("turb_model", "TurbulenceModel")):
        if f in base:
            rk[f] = getattr(R, enum_)(base[f])
            tk[f] = getattr(T, enum_)(base[f])
    rs = R.Simulation(R.Config(**rk))
    r = make(R, rs.cfg, rs.mesh)
    if rs.cfg.turb_model != R.TurbulenceModel.NONE:
        r = rs.initialize(r).replace(nu_t=None)
        r = r.replace(nu_t=rs.turb.nu_t(r, rs))
    ps = T.Simulation(T.Config(**tk), device="cpu")
    return rs, r, ps, _to_port(r)


@pytest.mark.parametrize("name", ["tgv3d", "poiseuille2d", "duct_stretched",
                                  "sst_channel"])
def test_vtk_and_profiles_are_the_references_bytes(name, tmp_path):
    """write_vtk (3-D binary, 2-D ASCII, stretched-axis sidecars, nu_t, k
    and omega, an extra scalar) and write_profiles: the reference's files
    byte for byte; read_vtk_scalars and read_vtk_dims read the fields
    back (binary exactly)."""
    rs, r, ps, p = _vtk_pair(name)
    extra = {"marker": np.arange(np.prod(p.p.shape), dtype=float).reshape(
        p.p.shape)}
    got, want = str(tmp_path / "port.vtk"), str(tmp_path / "ref.vtk")
    vtk.write_vtk(got, p, ps.mesh, ps.geom, ps.cfg, extra_scalars=extra)
    r_vtk.write_vtk(want, r, rs.mesh, rs.geom, rs.cfg, extra_scalars=extra)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    for axis in ("y", "z"):
        side = os.path.exists(want + f".{axis}coords.txt")
        assert os.path.exists(got + f".{axis}coords.txt") == side
        if side:
            with open(got + f".{axis}coords.txt") as a, \
                    open(want + f".{axis}coords.txt") as b:
                assert a.read() == b.read()
    assert vtk.read_vtk_dims(got) == tuple(p.p.shape)
    data = vtk.read_vtk_scalars(got)
    names = {"velocity", "pressure", "marker"} | (
        {"nu_t", "k", "omega"} if p.k is not None else set())
    assert set(data) == names
    back = data["pressure"].reshape(p.p.shape[::-1]).transpose(2, 1, 0)
    if ps.mesh.is_2d:
        np.testing.assert_allclose(back, p.p.numpy(), rtol=1e-8)
    else:
        np.testing.assert_array_equal(back, p.p.numpy())
    got_p, want_p = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    vtk.write_profiles(got_p, p, ps.mesh, ps.geom)
    r_vtk.write_profiles(want_p, r, rs.mesh, rs.geom)
    with open(got_p) as a, open(want_p) as b:
        assert a.read() == b.read()


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    """save_checkpoint / latest_checkpoint / load_checkpoint: the same
    ckpt_<step>/ layout and config JSON keys as the reference, every State
    member back bit for bit on the Simulation's device."""
    rs, r, ps, p = _vtk_pair("sst_channel")
    p = p.replace(step=torch.tensor(7, dtype=torch.int32),
                  t=torch.tensor(0.123, dtype=torch.float64))
    d = checkpoint.save_checkpoint(str(tmp_path), p, ps.cfg)
    assert os.path.basename(d) == "ckpt_000000007"
    assert checkpoint.latest_checkpoint(str(tmp_path)) == d
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    import json
    with open(os.path.join(d, "config.json")) as fh:
        keys = set(json.load(fh))
    import dataclasses
    assert keys == {f.name for f in dataclasses.fields(R.Config)}
    back = checkpoint.load_checkpoint(d, ps.cfg, sim=ps)
    for k in KEYS:
        a, b = getattr(p, k), getattr(back, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert b.device == ps.device and b.dtype == a.dtype, k
            assert torch.equal(a, b), k


def test_app_checkpoint_resume(tmp_path):
    """--checkpoint_dir / --checkpoint_interval save during a run, and
    --resume continues from the latest checkpoint, step 6 to 12, as the
    reference app does, with the same final state."""
    args = ["--Nx", "12", "--Ny", "16", "--Nz", "4", "--max_steps", "6",
            "--adaptive_dt", "false", "--dt", "1e-3", "--write_fields",
            "false", "--verbose", "false", "--platform", "cpu"]
    finals = {}
    for tag, mod in (("port", channel), ("ref", r_channel)):
        ck = str(tmp_path / tag)
        _, st1, _ = mod.main(args + ["--checkpoint_dir", ck,
                                     "--checkpoint_interval", "3"])
        assert int(st1.step) == 6
        assert any(x.startswith("ckpt_") for x in os.listdir(ck))
        _, st2, _ = mod.main(args + ["--checkpoint_dir", ck,
                                     "--checkpoint_interval", "3",
                                     "--resume", "true"])
        assert int(st2.step) == 12 and float(st2.t) > float(st1.t)
        finals[tag] = st2
    for k in ("u", "v", "w", "p"):
        want = np.asarray(getattr(finals["ref"], k))
        np.testing.assert_allclose(
            getattr(finals["port"], k).numpy(), want, rtol=0,
            atol=1e-12 * float(np.max(np.abs(want))), err_msg=k)
