"""Step timing (port of `cfdnn_tpu/utils/timing.py` marginal_step_seconds)."""

from __future__ import annotations

import time


def marginal_step_seconds(run_long, run_short, n_long: int, n_short: int,
                          reps: int = 3) -> float:
    """Differential wall time per step, cancelling constant per-call
    overhead (start-up, the final diagnostics step, the final sync).

    `run_long`/`run_short` are zero-arg callables that execute n_long /
    n_short steps and wait for the device to finish (on CUDA:
    `torch.cuda.synchronize()` inside the callable); both must already be
    warmed. Times each `reps` times interleaved, takes the per-length
    minimum (the least-noise estimator), and returns
    (t_long - t_short) / (n_long - n_short).

    Guard: if timing noise makes the marginal nonpositive, fall back to
    the naive t_long / n_long — a strict upper bound — so no consumer ever
    sees a zero or negative step time."""
    if not n_long > n_short >= 1:
        raise ValueError(f"need n_long > n_short >= 1, got {n_long}, {n_short}")
    best_l = best_s = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run_long()
        best_l = min(best_l, time.perf_counter() - t0)
        t0 = time.perf_counter()
        run_short()
        best_s = min(best_s, time.perf_counter() - t0)
    marginal = (best_l - best_s) / (n_long - n_short)
    if marginal <= 0.0:
        return best_l / n_long
    return marginal
