"""cfdnn_tpu_torch: the PyTorch/CUDA port of cfdnn_tpu for NVIDIA Hopper.

A second package beside the JAX reference `cfdnn_tpu`, with the same
module names, array layouts and Config. It imports torch and NumPy, never
JAX. It runs the reference's step with forward Euler, RK2 or RK3 at a fixed
or adaptive dt, laminar or with an LES, RANS (k-omega transport, EARSM)
or algebraic closure, with or without an immersed body (ibm/), carried on
the GPU by hand-written CUDA kernels (ops/kernels.py).
"""

# first: sets up torch's CPU vector math on one thread (utils/numerics.py)
from .utils import numerics  # noqa: F401
from .config import (BCType, Config, ConvectiveScheme, PoissonSolverType,
                     SimulationMode, TimeIntegrator, TurbulenceModel)
from .fields import (State, init_poiseuille, init_taylor_green,
                     perturbed_channel, poiseuille_exact, state_from_numpy,
                     state_to_numpy, velocity_shapes, zero_state)
from .ibm import CylinderBody, IBMForcing, create_ibm_body
from .mesh import Mesh
from .solver import Simulation, StepDiagnostics

__all__ = [
    "BCType", "Config", "ConvectiveScheme", "PoissonSolverType",
    "SimulationMode", "TimeIntegrator", "TurbulenceModel",
    "State", "init_poiseuille", "init_taylor_green", "perturbed_channel",
    "poiseuille_exact", "state_from_numpy", "state_to_numpy",
    "velocity_shapes", "zero_state", "CylinderBody", "IBMForcing",
    "create_ibm_body", "Mesh", "Simulation", "StepDiagnostics",
]
