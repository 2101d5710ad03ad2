"""Output layer: legacy VTK snapshots, text profiles and checkpoints (port
of `cfdnn_tpu/io/`)."""

from .vtk import read_vtk_dims, read_vtk_scalars, write_profiles, write_vtk

__all__ = ["write_vtk", "write_profiles", "read_vtk_scalars",
           "read_vtk_dims"]
