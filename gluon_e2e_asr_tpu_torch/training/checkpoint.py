"""The port's checkpoints.

Counterpart of ``gluon_e2e_asr_tpu/training/checkpoint.py``: a
``torch.save`` payload {"params": state dict, "cmvn": [mean, std] or
None} plus the same JSON meta sidecar (``<path>.json``: vocab,
config_hash, ...) the JAX trainer writes. Both files are written to a
temporary name and renamed, so a crash never leaves a torn checkpoint.
A JAX checkpoint enters the port through ``bridge.py``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def save_checkpoint(path: str, params: Mapping[str, torch.Tensor],
                    meta: Dict[str, Any], cmvn_stats=None) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "cmvn": None if cmvn_stats is None else [
            torch.as_tensor(np.asarray(x)) for x in cmvn_stats],
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    meta_tmp = path + ".json.tmp"
    with open(meta_tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(meta_tmp, path + ".json")
    return path


def restore_checkpoint(path: str, device: torch.device = torch.device("cpu")
                       ) -> Tuple[Dict[str, torch.Tensor], Optional[tuple],
                                  Dict[str, Any]]:
    """(params, cmvn_stats, meta) from ``path``; tensors on ``device``."""
    payload = torch.load(path, map_location=device, weights_only=True)
    cmvn = payload.get("cmvn")
    if cmvn is not None:
        cmvn = tuple(cmvn)
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return payload["params"], cmvn, meta
