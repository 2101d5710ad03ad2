"""VTK legacy output and text profiles (port of `cfdnn_tpu/io/vtk.py`).

STRUCTURED_POINTS, ASCII for 2-D and big-endian binary doubles for 3-D,
byte for byte the reference's files, so that its postprocessing and
spectral scripts read both packages' output unchanged. The fields come to
the host as NumPy arrays once a snapshot. The encoder is the reference's
NumPy one; its C encoder (`cfdnn_tpu/native/vtkio.c`) is ROADMAP A.15.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..turbulence.base import cell_center_velocity


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _vel_centers(state, geom):
    """Velocity interpolated to cell centres, as host NumPy arrays."""
    return [_host(c) for c in
            cell_center_velocity((state.u, state.v, state.w), geom)]


def write_vtk(path: str, state, mesh, geom, cfg,
              extra_scalars: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write a legacy-VTK snapshot of (velocity, pressure, [nu_t, k,
    omega], extra scalars).

    2-D: ASCII; 3-D: big-endian binary doubles when cfg.vtk_binary.
    STRUCTURED_POINTS takes one spacing a axis: stretched axes are written
    with their mean spacing, and sidecars `<path>.ycoords.txt` /
    `.zcoords.txt` carry the true centres.
    """
    u, v, w = _vel_centers(state, geom)
    Nx, Ny, Nz = mesh.Nx, mesh.Ny, mesh.Nz
    binary = bool(cfg.vtk_binary) and not mesh.is_2d

    scalars = {"pressure": _host(state.p)}
    if state.nu_t is not None:
        scalars["nu_t"] = _host(state.nu_t)
    if state.k is not None:
        scalars["k"] = _host(state.k)
        scalars["omega"] = _host(state.omega)
    if extra_scalars:
        scalars.update({k: np.asarray(a) for k, a in extra_scalars.items()})

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    dx = mesh.x.h
    # mean spacing on stretched axes (true coordinates in the sidecars)
    dy = float(np.mean(mesh.y.d))
    dz = float(np.mean(mesh.z.d)) if Nz > 1 else 1.0

    def c_order(a):
        # VTK iterates x fastest: (i, j, k) -> (k, j, i), then ravel
        return np.ascontiguousarray(np.transpose(a, (2, 1, 0)))

    with open(path, "wb" if binary else "w") as fh:
        def line(s):
            fh.write(s.encode() if binary else s)

        line("# vtk DataFile Version 3.0\n")
        line("cfdnn_tpu simulation output\n")
        line("BINARY\n" if binary else "ASCII\n")
        line("DATASET STRUCTURED_POINTS\n")
        line(f"DIMENSIONS {Nx} {Ny} {Nz}\n")
        # ORIGIN is the domain corner while the data are cell-centred: the
        # reference writer's half-cell shift, kept so that its scripts read
        # both packages' files alike; the sidecars carry true centres
        line(f"ORIGIN {mesh.x.lo} {mesh.y.lo} {mesh.z.lo}\n")
        line(f"SPACING {dx} {dy} {dz}\n")
        line(f"POINT_DATA {Nx * Ny * Nz}\n")

        line("VECTORS velocity double\n")
        vel = np.stack([c_order(u), c_order(v), c_order(w)], axis=-1)
        if binary:
            fh.write(vel.astype(">f8").tobytes())
        else:
            np.savetxt(fh, vel.reshape(-1, 3), fmt="%.9g")

        for name, arr in scalars.items():
            line(f"\nSCALARS {name} double 1\n")
            line("LOOKUP_TABLE default\n")
            if binary:
                fh.write(c_order(arr).reshape(-1).astype(">f8").tobytes())
            else:
                np.savetxt(fh, c_order(arr).reshape(-1), fmt="%.9g")

    if not mesh.y.uniform:
        np.savetxt(path + ".ycoords.txt", mesh.y.centers, fmt="%.16e")
    if not mesh.z.uniform:
        np.savetxt(path + ".zcoords.txt", mesh.z.centers, fmt="%.16e")


def _parse_dims(header: str) -> Tuple[int, int, int]:
    d = [int(x) for x in header.split("DIMENSIONS")[1].split("\n")[0].split()]
    return d[0], d[1], d[2]


def read_vtk_dims(path: str) -> Tuple[int, int, int]:
    """(Nx, Ny, Nz) from a STRUCTURED_POINTS header, reading the header
    only."""
    header = b""
    with open(path, "rb") as fh:
        while b"POINT_DATA" not in header:
            chunk = fh.read(65536)
            if not chunk:
                break
            header += chunk
    end = header.find(b"POINT_DATA")
    return _parse_dims(header[: end if end >= 0 else len(header)].decode())


def read_vtk_scalars(path: str) -> Dict[str, np.ndarray]:
    """Minimal reader for round trips: {name: flat array} for the scalar
    fields, and 'velocity' as (N, 3)."""
    out = {}
    with open(path, "rb") as fh:
        body = fh.read()
    header_end = body.find(b"POINT_DATA")
    header = body[:header_end].decode()
    binary = "BINARY" in header
    dims = _parse_dims(header)
    n = dims[0] * dims[1] * dims[2]
    pos = header_end
    while True:
        found = [x for x in (body.find(b"VECTORS", pos),
                             body.find(b"SCALARS", pos)) if x >= 0]
        if not found:
            break
        nxt = min(found)
        eol = body.find(b"\n", nxt)
        tokens = body[nxt:eol].decode().split()
        name = tokens[1]
        ncomp = 3 if tokens[0] == "VECTORS" else 1
        start = eol + 1
        if tokens[0] == "SCALARS":
            start = body.find(b"\n", start) + 1  # skip LOOKUP_TABLE
        if binary:
            count = n * ncomp
            arr = np.frombuffer(body, dtype=">f8", count=count, offset=start)
            pos = start + count * 8
        else:
            ends = [body.find(k, start) for k in (b"VECTORS", b"SCALARS")]
            text_end = min([x for x in ends if x >= 0], default=len(body))
            arr = np.array(body[start:text_end].decode().split(), dtype=float)
            pos = text_end
        out[name] = arr.reshape(-1, 3) if ncomp == 3 else arr
    return out


def write_profiles(path: str, state, mesh, geom) -> None:
    """Plane-averaged y-profiles as text: y, <u>, <v>, <w>, <p> [, <nu_t>,
    <k>, <omega>]."""
    u, v, w = _vel_centers(state, geom)
    cols = [mesh.y.centers,
            u.mean(axis=(0, 2)), v.mean(axis=(0, 2)), w.mean(axis=(0, 2)),
            _host(state.p).mean(axis=(0, 2))]
    names = ["y", "u_mean", "v_mean", "w_mean", "p_mean"]
    if state.nu_t is not None:
        cols.append(_host(state.nu_t).mean(axis=(0, 2)))
        names.append("nu_t_mean")
    if state.k is not None:
        cols.append(_host(state.k).mean(axis=(0, 2)))
        cols.append(_host(state.omega).mean(axis=(0, 2)))
        names += ["k_mean", "omega_mean"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, np.column_stack(cols), header=" ".join(names))
