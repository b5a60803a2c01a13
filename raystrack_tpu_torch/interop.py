"""Carry the JAX package's prepared state into the port.

This system has no weights: its state is the prepared scene and emitter
packs. Both functions take a dict of NumPy arrays keyed by the field names
of ``raystrack_tpu.prepared.ScenePack`` / ``EmitterPack`` (scalars as
ints; e.g. ``{f.name: np.asarray(getattr(pack, f.name)) ...}``) and return
the port's packs on ``device``, so one prepared state drives both packages.

Every field of the JAX scene pack carries across, the acceleration boxes
(``tile_lo``/``tile_hi``, None with acceleration off) included. A slim
(pack-resident) pack carries across as it is: ``tri_pack`` set and the
seven per-triangle fields None.
"""
from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict

import numpy as np
import torch

from .prepared import EmitterPack, ScenePack

_EMITTER_IGNORED = ("plane_host",)


def _convert(cls, d: Dict[str, Any], device: torch.device, ignored):
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            raise KeyError(f"{cls.__name__} field {f.name!r} missing")
        value = d[f.name]
        if f.type == "int":
            kwargs[f.name] = int(value)
        elif value is None:
            kwargs[f.name] = None
        else:
            # np.array copies: the caller's arrays may be read-only views
            kwargs[f.name] = torch.from_numpy(np.array(value)).to(device)
    extra = set(d) - {f.name for f in fields(cls)} - set(ignored)
    if extra:
        raise KeyError(f"{cls.__name__} has no fields {sorted(extra)}")
    return cls(**kwargs)


def scene_pack_from_arrays(d: Dict[str, Any], device: torch.device) -> ScenePack:
    """The port's ScenePack from a JAX ScenePack's fields as NumPy arrays
    (None for the fields a full or a slim pack leaves empty; a dict
    without ``tri_pack`` is a full pack)."""
    return _convert(ScenePack, {"tri_pack": None, **d}, torch.device(device), ())


def emitter_pack_from_arrays(d: Dict[str, Any], device: torch.device) -> EmitterPack:
    """The port's EmitterPack from a JAX EmitterPack's fields as NumPy arrays."""
    return _convert(EmitterPack, d, torch.device(device), _EMITTER_IGNORED)


__all__ = ["scene_pack_from_arrays", "emitter_pack_from_arrays"]
