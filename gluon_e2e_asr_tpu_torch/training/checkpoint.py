"""The port's checkpoints.

Counterpart of ``gluon_e2e_asr_tpu/training/checkpoint.py``: a
``torch.save`` payload {"params": state dict, "cmvn": [mean, std] or
None, and from the trainer "opt_state" and "step"} plus the same JSON
meta sidecar (``<path>.json``: vocab, config_hash, ...) the JAX trainer
writes. Both files are written to a temporary name and renamed, so a
crash never leaves a torn checkpoint. The trainer's checkpoints are
``<ckpt_dir>/ckpt_<step>.pt`` with a ``best.pt`` symlink, pruned as the
JAX ``_prune`` does. A JAX checkpoint enters the port through
``bridge.py``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pt$")


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, params: Mapping[str, torch.Tensor],
                    meta: Dict[str, Any], cmvn_stats=None, *,
                    opt_state: Optional[Dict[str, Any]] = None,
                    step: Optional[int] = None) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "params": _cpu(dict(params)),
        "cmvn": None if cmvn_stats is None else [
            torch.as_tensor(np.asarray(x)) for x in cmvn_stats],
    }
    if opt_state is not None:
        payload["opt_state"] = _cpu(opt_state)
    if step is not None:
        payload["step"] = int(step)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    meta_tmp = path + ".json.tmp"
    with open(meta_tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(meta_tmp, path + ".json")
    return path


def save_train_checkpoint(ckpt_dir: str, params: Mapping[str, torch.Tensor],
                          opt_state: Dict[str, Any], step: int,
                          meta: Dict[str, Any], cmvn_stats=None,
                          keep: int = 3, is_best: bool = False,
                          keep_policy: str = "last") -> str:
    """``<ckpt_dir>/ckpt_<step>.pt`` with the optimizer state; ``best.pt``
    (and its ``.json``) point at it when ``is_best``; then prune to the
    retention policy (see ``_prune``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pt")
    save_checkpoint(path, params, dict(meta, step=step), cmvn_stats,
                    opt_state=opt_state, step=step)
    if is_best:
        best = os.path.join(ckpt_dir, "best.pt")
        for suffix in ("", ".json"):
            link = best + suffix
            if os.path.lexists(link):
                os.remove(link)
            os.symlink(os.path.basename(path) + suffix, link)
    _prune(ckpt_dir, keep, keep_policy)
    return path


def _prune(ckpt_dir: str, keep: int, keep_policy: str = "last") -> None:
    """``keep_policy="last"`` keeps the newest ``keep`` checkpoints;
    ``"best"`` keeps the ``keep`` with the lowest ``dev_wer`` in their
    sidecar (missing ranks worst) plus the newest. The target of
    ``best.pt`` always stays. ``keep <= 0`` keeps everything."""
    if keep <= 0:
        return
    ckpts = sorted((int(m.group(1)), fn) for fn in os.listdir(ckpt_dir)
                   for m in [_CKPT_RE.match(fn)] if m)
    best = os.path.join(ckpt_dir, "best.pt")
    best_target = os.readlink(best) if os.path.islink(best) else None
    if keep_policy == "last":
        drop = [fn for _, fn in ckpts[:-keep]]
    elif keep_policy == "best":
        def dev_wer(fn: str) -> float:
            try:
                with open(os.path.join(ckpt_dir, fn + ".json")) as f:
                    v = json.load(f).get("dev_wer")
                return float(v) if v is not None else float("inf")
            except (OSError, ValueError):
                return float("inf")

        ranked = sorted((fn for _, fn in ckpts), key=lambda fn: (dev_wer(fn), fn))
        keep_set = set(ranked[:keep]) | {ckpts[-1][1]}
        drop = [fn for _, fn in ckpts if fn not in keep_set]
    else:
        raise ValueError(f"unknown keep_policy {keep_policy!r}")
    for fn in drop:
        if fn == best_target:
            continue
        for suffix in ("", ".json"):
            p = os.path.join(ckpt_dir, fn + suffix)
            if os.path.exists(p):
                os.remove(p)


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
