"""Headline benchmark of the PyTorch port on one CUDA card.

Runs the exact configurations of the reference's `bench.py` `bench_tgv`
(128^3 all-periodic Taylor-Green, skew, dt 1e-3), `bench_channel` (128^3
channel, stretched no-slip y, central, dt 2e-4) and `bench_les_channel`
(the same channel at 128x64x128 with the static Smagorinsky closure),
two LES grids of the port's own: `les_tgv` (bench_tgv with static
Smagorinsky) and `les_duct` (the square duct of the reference's
apps/duct.py, stretched walls in y and z, at 128x96x96 with WALE and the
LES channel's physics), and `rans_channel`, bench_channel with the SST
closure started from the closure's k/omega estimate: the RANS
configuration the reference measured its transport kernel on
(scripts/measure_upwind.py:58-68). Forward Euler in float32 and benchmark
mode; it prints one JSON line with bench.py's headline keys: ms/step and
Mcells/s of each grid, the wall-bounded grids' float32 post-projection
divergence, and the card.

The `*_vs_baseline` ratios of bench.py are left out: they divide by
published H200 and RTX 6000 figures, not by a measurement on this card.

    python -m cfdnn_tpu_torch.bench

A card is required; there is no CPU fallback for a measurement.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np
import torch

from . import (BCType, Config, ConvectiveScheme, Simulation, TimeIntegrator,
               TurbulenceModel, init_taylor_green, perturbed_channel)
from .utils.timing import marginal_step_seconds


def tgv_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """bench.py bench_tgv's configuration."""
    return Config(
        Nx=n, Ny=n, Nz=n,
        bc_x=BCType.PERIODIC, bc_y=BCType.PERIODIC, bc_z=BCType.PERIODIC,
        y_min=0.0, y_max=2 * np.pi, z_min=0.0, z_max=2 * np.pi,
        nu=1.0 / 1600.0, nu_specified=True, dp_dx=0.0, dp_dx_specified=True,
        dt=1e-3 if n <= 128 else 1e-4, adaptive_dt=False,
        time_integrator=TimeIntegrator.EULER,
        convective_scheme=ConvectiveScheme.SKEW,
        benchmark=True, dtype=dtype, **kw)


def channel_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """bench.py bench_channel's configuration."""
    return Config(
        Nx=n, Ny=n, Nz=n, stretch_y=True,
        nu=1e-4, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
        dt=2e-4 if n <= 128 else 5e-5, adaptive_dt=False,
        benchmark=True, dtype=dtype, **kw)


def les_channel_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """bench.py bench_les_channel's configuration: Nx = Nz = n, Ny = n/2
    (128x64x128), the channel's physics with static Smagorinsky. `kw`
    overrides any field (another closure, another Ny)."""
    base = dict(
        Nx=n, Ny=n // 2, Nz=n, stretch_y=True,
        nu=1e-4, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
        dt=2e-4, adaptive_dt=False, benchmark=True, dtype=dtype,
        turb_model=TurbulenceModel.SMAGORINSKY)
    base.update(kw)
    return Config(**base)


def les_tgv_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """bench_tgv's configuration with the static Smagorinsky closure (Cs
    0.17): the reference's LES Taylor-Green (tests/test_les_validation.py
    :15-26) at the width of examples/09_taylor_green_3d/tgv_re1600.cfg, on
    bench.py's integrator (Euler, fixed dt). `kw` overrides any field."""
    return tgv_config(n, dtype, **{"turb_model": TurbulenceModel.SMAGORINSKY,
                                   **kw})


def les_duct_config(n: int = 128, dtype: str = "float32", **kw) -> Config:
    """The square duct of the reference's apps/duct.py (x in [0, 4]
    periodic; y, z in [-1, 1], no-slip walls on both; central) at the LES
    channel's density, Nx = n and Ny = Nz = 3n/4 (128x96x96), both walls
    stretched (beta 2), with bench_les_channel's physics (nu 1e-4, dp_dx
    -1e-3, dt 2e-4) and the WALE closure, which needs no wall damping.
    `kw` overrides any field."""
    base = dict(
        Nx=n, Ny=3 * n // 4, Nz=3 * n // 4,
        x_min=0.0, x_max=4.0, y_min=-1.0, y_max=1.0, z_min=-1.0, z_max=1.0,
        bc_x=BCType.PERIODIC, bc_y=BCType.WALL, bc_z=BCType.WALL,
        stretch_y=True, stretch_z=True,
        nu=1e-4, nu_specified=True, dp_dx=-1e-3, dp_dx_specified=True,
        dt=2e-4, adaptive_dt=False, benchmark=True, dtype=dtype,
        turb_model=TurbulenceModel.WALE)
    base.update(kw)
    return Config(**base)


def rans_channel_config(n: int = 128, dtype: str = "float32",
                        **kw) -> Config:
    """bench.py bench_channel's configuration with the SST k-omega closure
    (scripts/measure_upwind.py:58-68). `kw` overrides any field (another
    RANS closure, another Ny)."""
    return channel_config(n, dtype).with_(
        **{"turb_model": TurbulenceModel.SST, **kw})


def tgv_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the TGV benchmark."""
    sim = Simulation(tgv_config(n, dtype, **kw), device=device)
    return sim, init_taylor_green(sim.cfg, sim.mesh, device=device)


def les_tgv_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the LES Taylor-Green."""
    sim = Simulation(les_tgv_config(n, dtype, **kw), device=device)
    return sim, init_taylor_green(sim.cfg, sim.mesh, device=device)


def _noisy_case(config, n, device, dtype, kw):
    """A wall-bounded grid started from perturbed_channel(amp=0.05), the
    noise from a torch.Generator seeded with kw's `seed` (default 0)."""
    seed = kw.pop("seed", 0)
    sim = Simulation(config(n, dtype, **kw), device=device)
    gen = torch.Generator(device=sim.device).manual_seed(seed)
    return sim, perturbed_channel(sim.cfg, sim.mesh, gen, amp=0.05,
                                  device=device)


def channel_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the channel benchmark."""
    return _noisy_case(channel_config, n, device, dtype, kw)


def les_channel_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the LES channel benchmark."""
    return _noisy_case(les_channel_config, n, device, dtype, kw)


def les_duct_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the LES duct; the first step's BC
    pass zeroes the noise on w's z-wall faces."""
    return _noisy_case(les_duct_config, n, device, dtype, kw)


def rans_channel_case(n=128, device="cuda", dtype="float32", **kw):
    """(Simulation, initial State) of the RANS channel: perturbed_channel
    (amp 0.05) through `Simulation.initialize`, which sets k and omega to
    the closure's channel estimate (scripts/measure_upwind.py:43)."""
    sim, st = _noisy_case(rans_channel_config, n, device, dtype, kw)
    return sim, sim.initialize(st)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(sim, state, steps=1000, reps=3):
    """Differential best-of-reps seconds/step of `sim.run` (the constant
    per-call cost, including the final diagnostics step, cancels) and the
    diagnostics of the first run."""
    short = max(steps // 5, 1)
    state, d = sim.run(state, steps)
    sim.run(state, short)
    _sync(sim.device)
    if not math.isfinite(float(d.ke)):
        raise FloatingPointError("NaN in benchmark run")

    def run(n):
        sim.run(state, n)
        _sync(sim.device)

    s = marginal_step_seconds(lambda: run(steps), lambda: run(short),
                              steps, short, reps)
    return s, d


def device_events(prof):
    """The device-side entries (kernels, copies, fills) of a finished
    torch.profiler run's key_averages()."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def profiled(fn, windows=3):
    """(device events, host seconds) of `fn()` under torch.profiler (CPU
    and CUDA activities, ended by a synchronize), from the window of
    `windows` that recorded the most device events: the profiler has been
    seen to drop part of a window's events (a kernel read 0 ms), and a
    window that drops events records fewer."""
    from torch.profiler import ProfilerActivity, profile
    best = None
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = device_events(prof)
        count = sum(e.count for e in events)
        if best is None or count > best[0]:
            best = (count, events, wall)
    return best[1], best[2]


def profile_steps(sim, state, steps=20):
    """Device time of a window of `steps` steps, by kernel, from
    torch.profiler (CUPTI, `profiled`): {"device_ms_per_step": total kernel
    time per step, "wall_ms_per_step": the profiled window's host time per
    step, "kernels": [(name, ms per step, launches per step), ...] longest
    first}. The window is one `sim.run`, so its last step carries the
    diagnostics reductions."""
    sim.run(state, steps)
    _sync(sim.device)
    events, wall = profiled(lambda: sim.run(state, steps))
    rows = sorted(((e.key, e.self_device_time_total / steps / 1e3,
                    e.count / steps) for e in events),
                  key=lambda r: -r[1])
    return {"device_ms_per_step": sum(r[1] for r in rows),
            "wall_ms_per_step": wall * 1e3 / steps, "kernels": rows}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("cfdnn_tpu_torch.bench: no CUDA device; the "
                         "benchmark measures the card and has no CPU path")
    s_tgv, _ = time_steps(*tgv_case())
    s_ch, d_ch = time_steps(*channel_case())
    # the reference times its LES row over 400 steps, and so are the
    # port's LES rows
    s_les, d_les = time_steps(*les_channel_case(), steps=400)
    s_ltgv, _ = time_steps(*les_tgv_case(), steps=400)
    s_duct, d_duct = time_steps(*les_duct_case(), steps=400)
    # 400/80 steps, as scripts/measure_upwind.py:37 times its RANS row
    s_rans, d_rans = time_steps(*rans_channel_case(), steps=400)
    cells = 128 ** 3
    les_cells = 128 * 64 * 128
    duct_cells = 128 * 96 * 96
    print(json.dumps({
        "tgv_ms_per_step": s_tgv * 1e3,
        "tgv_mcells_per_s": cells / s_tgv / 1e6,
        "channel_ms_per_step": s_ch * 1e3,
        "channel_mcells_per_s": cells / s_ch / 1e6,
        "channel_div_linf_f32": float(d_ch.div_linf),
        "les_channel_ms_per_step": s_les * 1e3,
        "les_channel_mcells_per_s": les_cells / s_les / 1e6,
        "les_channel_div_linf_f32": float(d_les.div_linf),
        "les_tgv_ms_per_step": s_ltgv * 1e3,
        "les_tgv_mcells_per_s": cells / s_ltgv / 1e6,
        "les_duct_ms_per_step": s_duct * 1e3,
        "les_duct_mcells_per_s": duct_cells / s_duct / 1e6,
        "les_duct_div_linf_f32": float(d_duct.div_linf),
        "rans_channel_ms_per_step": s_rans * 1e3,
        "rans_channel_mcells_per_s": cells / s_rans / 1e6,
        "rans_channel_div_linf_f32": float(d_rans.div_linf),
        "device": torch.cuda.get_device_name(0),
    }), flush=True)


if __name__ == "__main__":
    main()
