"""Turbulence model factory (port of `cfdnn_tpu/turbulence/registry.py`)."""

from __future__ import annotations

from ..config import Config, TurbulenceModel

_NN = ("nn_mlp", "nn_tbnn")


def build(model: TurbulenceModel, cfg: Config, mesh, geom):
    from . import algebraic, earsm, les, transport
    T = TurbulenceModel
    constructors = {
        T.BASELINE: algebraic.MixingLengthModel,
        T.GEP: algebraic.GEPModel,
        T.SST: transport.SSTTransport,
        T.KOMEGA: transport.KOmegaTransport,
        T.EARSM_WJ: earsm.WallinJohanssonEARSM,
        T.EARSM_GS: earsm.GatskiSpezialeEARSM,
        T.SMAGORINSKY: les.SmagorinskyModel,
        T.DYNAMIC_SMAGORINSKY: les.DynamicSmagorinskyModel,
        T.WALE: les.WALEModel,
        T.VREMAN: les.VremanModel,
        T.SIGMA: les.SigmaModel,
    }
    if model in constructors:
        return constructors[model](cfg, mesh, geom)
    if model == T.EARSM_POPE:
        return earsm.PopeQuadraticEARSM(cfg, mesh, geom, C1=cfg.pope_C1,
                                        C2=cfg.pope_C2)
    if model.value in _NN:
        raise NotImplementedError(
            f"turb_model={model.value}: the NN closures are not in the port "
            "yet; ROADMAP A.12")
    raise ValueError(f"unknown turbulence model {model}")
