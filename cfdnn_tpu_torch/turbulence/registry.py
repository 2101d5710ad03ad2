"""Turbulence model factory (port of `cfdnn_tpu/turbulence/registry.py`)."""

from __future__ import annotations

from ..config import Config, TurbulenceModel

_RANS = ("baseline", "gep", "sst", "komega", "earsm_wj", "earsm_gs",
         "earsm_pope")
_NN = ("nn_mlp", "nn_tbnn")


def build(model: TurbulenceModel, cfg: Config, mesh, geom):
    from . import les
    T = TurbulenceModel
    if model == T.SMAGORINSKY:
        return les.SmagorinskyModel(cfg, mesh, geom)
    if model == T.DYNAMIC_SMAGORINSKY:
        return les.DynamicSmagorinskyModel(cfg, mesh, geom)
    if model == T.WALE:
        return les.WALEModel(cfg, mesh, geom)
    if model == T.VREMAN:
        return les.VremanModel(cfg, mesh, geom)
    if model == T.SIGMA:
        return les.SigmaModel(cfg, mesh, geom)
    if model.value in _RANS:
        raise NotImplementedError(
            f"turb_model={model.value}: the RANS and EARSM closures are not "
            "in the port yet; ROADMAP A.11")
    if model.value in _NN:
        raise NotImplementedError(
            f"turb_model={model.value}: the NN closures are not in the port "
            "yet; ROADMAP A.12")
    raise ValueError(f"unknown turbulence model {model}")
