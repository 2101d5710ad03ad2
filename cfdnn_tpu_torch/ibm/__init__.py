"""Immersed-boundary method: SDF bodies and direct forcing (port of
`cfdnn_tpu/ibm/`)."""

from .forcing import IBMForcing
from .geometry import (BackwardStepBody, CylinderBody, IBMBody, NACABody,
                       PeriodicHillBody, SphereBody, StepBody,
                       create_ibm_body)

__all__ = [
    "IBMForcing", "IBMBody", "CylinderBody", "SphereBody", "NACABody",
    "StepBody", "BackwardStepBody", "PeriodicHillBody", "create_ibm_body",
]
