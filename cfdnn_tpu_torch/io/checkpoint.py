"""Checkpoint and resume (port of `cfdnn_tpu/io/checkpoint.py`).

`<path>/ckpt_<step>/` holds the State's tensors (`torch.save` of a dict
keyed as `fields._STATE_KEYS`, in place of the reference's orbax tree) and
the config as JSON, written under a temporary name and renamed into place,
so that a run killed mid-save never leaves a half-written latest
checkpoint. A reload is bit-exact and lands on the Simulation's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

import torch

from ..config import Config
from ..fields import _STATE_KEYS, State, zero_state

_STATE_FILE = "state.pt"


def save_checkpoint(path: str, state: State, cfg: Config,
                    step: Optional[int] = None) -> str:
    """Write `<path>/ckpt_<step>/` (the state's step unless given) with the
    state's tensors and the config JSON; returns the directory."""
    step = int(state.step) if step is None else step
    d = os.path.join(path, f"ckpt_{step:09d}")
    tmp = d + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    tensors = {k: getattr(state, k).detach().cpu() for k in _STATE_KEYS
               if getattr(state, k) is not None}
    torch.save(tensors, os.path.join(tmp, _STATE_FILE))
    cfg_json = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        cfg_json[f.name] = (v.value if hasattr(v, "value") else
                            list(v) if isinstance(v, tuple) else v)
    with open(os.path.join(tmp, "config.json"), "w") as fh:
        json.dump(cfg_json, fh, indent=1, default=str)
    if os.path.isdir(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    return d


def latest_checkpoint(path: str) -> Optional[str]:
    """The newest complete checkpoint under `path` (a directory renamed
    into place, with its config.json), or None."""
    if not os.path.isdir(path):
        return None
    cks = sorted(x for x in os.listdir(path)
                 if x.startswith("ckpt_") and not x.endswith(".tmp")
                 and os.path.exists(os.path.join(path, x, "config.json")))
    return os.path.join(path, cks[-1]) if cks else None


def load_checkpoint(d: str, cfg: Config, sim) -> State:
    """Restore a State from checkpoint directory `d` onto `sim`'s device;
    members the checkpoint lacks take zero_state's values (an optional
    member it lacks stays None). The tensors come back as saved, bit for
    bit, in the dtype of `cfg`."""
    proto = zero_state(cfg, device=sim.device)
    data = torch.load(os.path.join(d, _STATE_FILE), map_location=sim.device,
                      weights_only=True)
    kw = {}
    for name in _STATE_KEYS:
        if name in data:
            ref = getattr(proto, name)
            kw[name] = data[name].to(ref.dtype if ref is not None
                                     else getattr(torch, cfg.dtype))
    return proto.replace(**kw)
