"""Overflow-safe numerics helpers (port of `cfdnn_tpu/utils/numerics.py`)."""

from __future__ import annotations

import torch


def _init_cpu_vector_math() -> None:
    """Run torch's MKL-backed CPU vector math once, on one thread.

    On CPU tensors torch computes sqrt, exp, log, tanh and the other
    transcendental functions through MKL's vector math library, in chunks
    of 2048 elements spread over the OpenMP threads. MKL sets that library
    up lazily, at its first call. When the first call of a process is a
    parallel one, a worker thread can race the set-up and compute its
    chunk less accurately: safe_sqrt's first call on a 16x12x12 float64
    field then gave the upper half of its cells off by up to 3e-11
    relative (1.4e5 ulp), in about one process in eight, and every later
    call was correctly rounded. A one-element call, below the chunk size
    and so on this thread alone, does the set-up first.
    """
    torch.sqrt(torch.ones(1, dtype=torch.float64))


_init_cpu_vector_math()


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) whose gradient is 0 (not inf/NaN) at x <= 0.

    d/dx sqrt(x) = 1/(2 sqrt(x)) blows up at x = 0, so autograd through a
    strain magnitude NaNs wherever the flow is locally at rest. The
    double-where form keeps the forward value exact and pins the
    subgradient to zero there.
    """
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def safe_tanh(x: torch.Tensor, cap: float = 30.0) -> torch.Tensor:
    """tanh with the argument clamped to +-cap (tanh(30) == 1.0 to 26
    digits). The SST and EARSM blending functions feed tanh arguments as
    large as 1e18, and inf where a float32 power overflows; the clamp
    maps +-inf to +-cap and lets a NaN through (torch.clamp)."""
    return torch.tanh(torch.clamp(x, -cap, cap))
