"""Turbulence closures (port of `cfdnn_tpu/turbulence/__init__.py`).

The LES family (les.py), the k-omega transport models SST and Wilcox
(transport.py), the EARSM trio on SST transport (earsm.py) and the
algebraic mixing-length and GEP closures (algebraic.py) are ported; the NN
closures raise NotImplementedError naming ROADMAP A.12 (registry.py).
"""

from __future__ import annotations

from ..config import Config, TurbulenceModel


class NoModel:
    """Laminar: nu_t = None (treated as zero everywhere)."""

    name = "none"
    provides_reynolds_stresses = False
    kernel = None

    def initialize(self, state, sim):
        return state

    def advance(self, state, sim, dt):
        return state

    def nu_t(self, state, sim):
        return None

    def advance_and_nu_t(self, state, sim, dt):
        return state, None

    def reynolds_stresses(self, state, sim):
        return None


def create_turbulence_model(cfg: Config, mesh, geom):
    m = cfg.turb_model
    if m == TurbulenceModel.NONE:
        return NoModel()
    from . import registry
    return registry.build(m, cfg, mesh, geom)
