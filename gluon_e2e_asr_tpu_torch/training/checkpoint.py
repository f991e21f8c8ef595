"""The port's checkpoints.

Counterpart of ``gluon_e2e_asr_tpu/training/checkpoint.py``: a
``torch.save`` payload {"params": state dict, "cmvn": [mean, std] or
None, and from the trainer "opt_state", "step" and "generator", the
step's ``torch.Generator`` state (the JAX ``TrainState.rng``: without it
a resumed run would draw other SpecAugment masks, coins and dropout
masks)} plus the same JSON meta sidecar (``<path>.json``: vocab,
config_hash, epoch, batches_done, best_wer, ...) the JAX trainer writes.
Both files are written to a temporary name and renamed, so a crash never
leaves a torn checkpoint. The trainer's checkpoints are
``<ckpt_dir>/ckpt_<step>.pt`` with a ``best.pt`` symlink, pruned as the
JAX ``_prune`` does; ``latest_checkpoint`` finds the newest and
``restore_train_checkpoint`` reads it back, whole (resume) or its
parameters and step alone, whatever optimizer wrote it (``params_only``,
as the JAX ``restore_checkpoint(..., params_only=True)``). A JAX
checkpoint enters the port through ``bridge.py``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

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
                    step: Optional[int] = None,
                    generator: Optional[torch.Tensor] = None) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "params": _cpu(dict(params)),
        # The trainer's stats are tensors on its device (global CMVN);
        # a decoding checkpoint's may be numpy arrays.
        "cmvn": None if cmvn_stats is None else [
            torch.as_tensor(x).detach().cpu() for x in cmvn_stats],
    }
    if opt_state is not None:
        payload["opt_state"] = _cpu(opt_state)
    if step is not None:
        payload["step"] = int(step)
    if generator is not None:
        payload["generator"] = generator.clone()
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
                          keep_policy: str = "last",
                          generator: Optional[torch.Tensor] = None) -> str:
    """``<ckpt_dir>/ckpt_<step>.pt`` with the optimizer state and the
    step's generator state (``torch.Generator.get_state()``); ``best.pt``
    (and its ``.json``) point at it when ``is_best``; then prune to the
    retention policy (see ``_prune``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pt")
    save_checkpoint(path, params, dict(meta, step=step), cmvn_stats,
                    opt_state=opt_state, step=step, generator=generator)
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
    return _unpack(path, torch.load(path, map_location=device,
                                    weights_only=True))


def restore_params(path: str) -> Tuple[Dict[str, torch.Tensor],
                                      Optional[tuple], Dict[str, Any]]:
    """(params, cmvn_stats, meta) of a port checkpoint, or of a JAX
    trainer's (a flax msgpack, told apart by its first bytes) converted
    through ``bridge.py``; tensors on the CPU."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"PK\x03\x04":  # torch.save's archive
        return restore_checkpoint(path)
    from gluon_e2e_asr_tpu_torch.bridge import params_from_jax, read_jax_checkpoint

    tree, cmvn, meta = read_jax_checkpoint(path)
    return params_from_jax(tree), cmvn, meta


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The trainer's newest ``ckpt_<step>.pt`` in ``ckpt_dir`` (by step),
    or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = sorted((int(m.group(1)), fn) for fn in os.listdir(ckpt_dir)
                   for m in [_CKPT_RE.match(fn)] if m)
    return os.path.join(ckpt_dir, ckpts[-1][1]) if ckpts else None


class TrainCheckpoint(NamedTuple):
    """What ``restore_train_checkpoint`` reads: ``opt_state`` and
    ``generator`` are None for a ``params_only`` restore."""
    params: Dict[str, torch.Tensor]
    step: int
    opt_state: Optional[Dict[str, Any]]
    generator: Optional[torch.Tensor]
    cmvn: Optional[tuple]
    meta: Dict[str, Any]


def _same_structure(a, b) -> bool:
    """Whether two optimizer states have the same family, keys and
    shapes."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _same_structure(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.shape == b.shape
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return type(a) is type(b)


def restore_train_checkpoint(path: str, opt_template: Optional[Dict[str, Any]]
                             = None, device: torch.device =
                             torch.device("cpu"), params_only: bool = False
                             ) -> TrainCheckpoint:
    """A trainer checkpoint, tensors on ``device``. Whole (resume): the
    parameters, the optimizer state, which must have the structure of
    ``opt_template`` (a checkpoint of another optimizer family raises),
    the step and the generator state. With ``params_only`` the
    parameters and the step alone, whatever optimizer wrote the file."""
    payload = torch.load(path, map_location=device, weights_only=True)
    params, cmvn, meta = _unpack(path, payload)
    step = int(payload.get("step", meta.get("step", 0)))
    if params_only:
        return TrainCheckpoint(params, step, None, None, cmvn, meta)
    for key in ("opt_state", "generator"):
        if key not in payload:
            raise ValueError(f"{path} holds no {key}: not a trainer "
                             "checkpoint (restore it params_only)")
    opt_state = payload["opt_state"]
    if opt_template is not None and not _same_structure(opt_state,
                                                        opt_template):
        raise ValueError(
            f"{path} holds the state of optimizer "
            f"{opt_state.get('kind', 'adam')!r}, this run's optimizer is "
            f"{opt_template.get('kind')!r} (or its parameters differ): "
            "restore it params_only")
    return TrainCheckpoint(params, step, opt_state,
                           payload["generator"].cpu(), cmvn, meta)


def _unpack(path: str, payload) -> Tuple[Dict[str, torch.Tensor],
                                         Optional[tuple], Dict[str, Any]]:
    cmvn = payload.get("cmvn")
    if cmvn is not None:
        cmvn = tuple(cmvn)
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return payload["params"], cmvn, meta
