"""Tensor-basis helpers of the data-driven closures (port of
`cfdnn_tpu/turbulence/features.py`, in part).

Only `anisotropy_to_stress`, which the EARSM closures use, is ported; the
scalar features and the TBNN invariants and basis come with the NN
closures (ROADMAP A.12).
"""

from __future__ import annotations


def anisotropy_to_stress(b_xx, b_xy, b_yy, k):
    """tau_ij = 2 k (b_ij + delta_ij / 3), the in-plane components."""
    third = 1.0 / 3.0
    return (2.0 * k * (b_xx + third),
            2.0 * k * b_xy,
            2.0 * k * (b_yy + third))
