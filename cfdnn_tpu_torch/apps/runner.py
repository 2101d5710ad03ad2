"""Shared command-line runner of the case apps (port of
`cfdnn_tpu/apps/runner.py`).

Each case module supplies a default Config, an initial condition, an
immersed body where it has one and a validation hook, and calls
`run_case`: config-file and `--key value`
overrides, the Simulation on the device `--platform` names, steady or
unsteady stepping with console diagnostics, VTK snapshots, checkpoints
and `--resume`, final fields and profiles, and the `QOI_JSON:` lines.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config, SimulationMode
from ..io.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..io.vtk import write_profiles, write_vtk
from ..solver import Simulation


def select_device(platform: str) -> torch.device:
    """The torch device of Config.platform: "" (the default), "gpu" or
    "cuda" -> the CUDA card, which must be there; "cpu" -> the CPU. The
    port does not run on a TPU."""
    p = platform.lower()
    if p in ("", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"platform={platform!r}: no CUDA device is available; pass "
                "--platform cpu to run on the CPU")
        return torch.device("cuda")
    if p == "cpu":
        return torch.device("cpu")
    raise ValueError(f"platform={platform!r}: the PyTorch port runs on a "
                     "CUDA card ('', 'gpu', 'cuda') or the CPU ('cpu')")


def run_case(name: str, cfg: Config, argv=None,
             ic: Optional[Callable] = None,
             body=None,
             validate: Optional[Callable] = None,
             callback: Optional[Callable] = None):
    """Parse CLI overrides, run to steady state or for max_steps, write
    outputs; returns (sim, state, diags). `ic(cfg, mesh, device=...)` makes
    the initial State (zero_state when None); `body` is an IBMBody (or a
    ready IBMForcing), or `body(cfg, mesh)` makes one, attached before the
    initial state; `callback(it, state, diags)`
    runs after the console's at each callback of the stepping (every step
    unsteady, every diag_interval steps steady)."""
    argv = sys.argv[1:] if argv is None else argv
    cfg = cfg.parse_args(argv).finalize()
    device = select_device(cfg.platform)
    sim = Simulation(cfg, device=device)
    if body is not None:
        sim.set_ibm_forcing(body(cfg, sim.mesh) if callable(body) else body)
    state = (ic(cfg, sim.mesh, device=device) if ic
             else sim.initial_state())
    state = sim.initialize(state)
    if cfg.resume and cfg.checkpoint_dir:
        d = latest_checkpoint(cfg.checkpoint_dir)
        if d is not None:
            state = load_checkpoint(d, cfg, sim=sim)
            if cfg.verbose:
                print(f"[{name}] resumed from {d} "
                      f"(step {int(state.step)}, t={float(state.t):.4f})")

    if cfg.verbose:
        print(f"[{name}] {cfg.Nx}x{cfg.Ny}x{cfg.Nz} "
              f"Re={cfg.Re:g} nu={cfg.nu:g} model={cfg.turb_model.value} "
              f"poisson={sim.poisson_selection_reason} dtype={cfg.dtype} "
              f"device={device}")

    n_snap = cfg.num_snapshots
    snap_every = max(1, cfg.max_steps // n_snap) if n_snap > 0 else 0
    t0 = time.perf_counter()
    step0 = int(state.step)       # nonzero after --resume
    last_ck = [step0]
    last_out = [0]
    last_snap = [0]

    def console(it, st, d):
        gstep = step0 + it        # global step: resume-safe file numbering
        # ">= interval since the last" rather than a modulo: steady mode
        # calls back every diag_interval steps only, which a modulo whose
        # period is not a multiple of it could alias
        if cfg.verbose and it - last_out[0] >= cfg.output_freq:
            last_out[0] = it
            print(f"  step {it:7d}  t={float(st.t):.4f} "
                  f"dt={float(d.dt):.2e} res={float(d.residual):.3e} "
                  f"div={float(d.div_linf):.3e} ke={float(d.ke):.6f}")
        if (snap_every and cfg.write_fields
                and it - last_snap[0] >= snap_every):
            last_snap[0] = it
            write_vtk(os.path.join(cfg.output_dir,
                                   f"{name}_{gstep:07d}.vtk"),
                      st, sim.mesh, sim.geom, cfg)
        if (cfg.checkpoint_dir and cfg.checkpoint_interval
                and gstep - last_ck[0] >= cfg.checkpoint_interval):
            save_checkpoint(cfg.checkpoint_dir, st, cfg)
            last_ck[0] = gstep
        if callback:
            callback(it, st, d)

    if cfg.simulation_mode == SimulationMode.STEADY:
        state, diags = sim.solve_steady(state, callback=console)
    else:
        state, diags = sim.advance_unsteady(state, cfg.max_steps,
                                            callback=console)
    wall = time.perf_counter() - t0

    if cfg.verbose:
        ncell = cfg.Nx * cfg.Ny * cfg.Nz
        steps = int(state.step)
        print(f"[{name}] done: {steps} steps, {wall:.2f}s wall, "
              f"{ncell * max(steps, 1) / max(wall, 1e-9) / 1e6:.1f} Mcells/s")
    if cfg.write_fields:
        write_vtk(os.path.join(cfg.output_dir, f"{name}_final.vtk"),
                  state, sim.mesh, sim.geom, cfg)
        write_profiles(os.path.join(cfg.output_dir, f"{name}_profiles.txt"),
                       state, sim.mesh, sim.geom)
    if validate:
        qois = validate(sim, state, diags) or {}
        for k, v in qois.items():
            # app-prefixed keys: un-prefixed ones from different apps
            # would collide in a metrics collector
            key = k if k.startswith(name) else f"{name}_{k}"
            if not np.isfinite(float(v)):
                # "value": nan is not valid JSON
                print(f"[{name}] QOI {key} is non-finite; skipped")
                continue
            print(f'QOI_JSON: {{"name": "{key}", "value": {float(v):.6e}}}')
    return sim, state, diags
