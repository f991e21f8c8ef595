"""The training step: frontend -> encoder -> CTC loss -> clip -> Adam.

Counterpart of ``gluon_e2e_asr_tpu/training/train_step.py`` for CTC-only
training (``loss.mtl_alpha: 1.0``). The optimizer is the JAX package's
optax chain written out, because torch's defaults differ from it:

- the LR schedule is evaluated at the update count *before* the
  increment, so the first update of a warmup runs at LR 0
  (``optax.linear_schedule`` inside ``optax.join_schedules``, which
  hands the inverse-sqrt part ``count - warmup``);
- ``optax.clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
- Adam is optax's (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
  bias-corrected), with decoupled weight decay as ``optax.adamw``.

The values follow optax's float32 arithmetic. The step's randomness
(SpecAugment) comes from an explicit ``torch.Generator`` in the
``TrainState``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import Config, TrainConfig
from gluon_e2e_asr_tpu_torch.frontend.features import (
    draw_spec_augment, frontend_apply, num_frames, specaug_on)
from gluon_e2e_asr_tpu_torch.models.asr import ASRModel
from gluon_e2e_asr_tpu_torch.ops.ctc import ctc_loss
from gluon_e2e_asr_tpu_torch.ops.losses import hybrid_loss

Params = Mapping[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip_norm),
    adamw(schedule, weight_decay))`` as the JAX ``make_optimizer``
    builds it for ``optimizer: adam|adamw``."""

    def __init__(self, tc: TrainConfig):
        self.lr_peak = float(tc.learning_rate)
        self.warmup = int(tc.warmup_steps)
        self.weight_decay = float(tc.weight_decay)
        self.clip = float(tc.grad_clip_norm)

    def lr(self, count: int) -> float:
        """The learning rate of the update made at ``count`` updates."""
        f32 = np.float32
        lr, w = f32(self.lr_peak), self.warmup
        if w <= 0:
            return float(lr)
        if count < w:
            frac = f32(1.0) - f32(min(max(count, 0), w)) / f32(w)
            return float((f32(0.0) - lr) * frac + lr)
        s = count - w
        return float(lr * np.sqrt(f32(w) / f32(max(s + w, 1))))

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               state: Dict[str, Any]) -> torch.Tensor:
        """Apply one update to ``params`` in place and advance ``state``.
        Returns the global norm of ``grads`` before clipping."""
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                              for g in grads.values()))
        count = state["count"]
        lr = self.lr(count)
        c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count + 1))
        c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count + 1))
        for k, p in params.items():
            g = grads[k].float()
            if self.clip > 0:
                g = torch.where(norm < self.clip, g, (g / norm) * self.clip)
            mu = (1.0 - B1) * g + B1 * state["mu"][k]
            nu = (1.0 - B2) * (g * g) + B2 * state["nu"][k]
            state["mu"][k], state["nu"][k] = mu, nu
            upd = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            p.add_(upd * (-lr))
        state["count"] = count + 1
        return norm


def make_optimizer(config: Config) -> Optimizer:
    tc = config.train
    if tc.optimizer in ("sgd", "adadelta"):
        raise NotImplementedError(
            f"train.optimizer={tc.optimizer!r} is not ported yet; adam and "
            "adamw are (ROADMAP.md)")
    if tc.optimizer not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {tc.optimizer}")
    return Optimizer(tc)


@dataclass
class TrainState:
    step: int
    opt_state: Dict[str, Any]
    generator: torch.Generator  # SpecAugment's draws


def create_train_state(config: Config, model: ASRModel, optimizer: Optimizer,
                       device: torch.device = torch.device("cpu")
                       ) -> TrainState:
    """A fresh state: ``model``'s parameters drawn on the CPU from
    ``train.seed`` and moved to ``device`` (in place), a zero optimizer
    state and the step's generator."""
    seed = int(config.train.seed)
    model.encoder.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    return TrainState(step=0,
                      opt_state=optimizer.init(dict(model.named_parameters())),
                      generator=torch.Generator().manual_seed(seed + 1))


def compute_loss(model: ASRModel, batch: Mapping[str, torch.Tensor],
                 config: Config, *, spec_draws=None, cmvn_stats=None,
                 train: bool = True
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and the joint loss of ``batch`` (tensors on the model's
    device: audio, audio_len, labels, label_len), normalized by the real
    (non-pad) row count. The model has no attention decoder, so the
    attention part is 0."""
    feats, feat_len = frontend_apply(
        config.frontend, batch["audio"], batch["audio_len"], train=train,
        spec_draws=spec_draws, cmvn_stats=cmvn_stats)
    labels, label_len = batch["labels"], batch["label_len"]
    num_real = (batch["audio_len"] > 0).sum()
    out = model(feats, feat_len, train=train)
    mtl_alpha = config.loss.mtl_alpha
    if mtl_alpha > 0.0:
        ctc_nll = ctc_loss(out["ctc_logits"], out["enc_len"], labels,
                           label_len, blank_id=0)
    else:
        ctc_nll = torch.zeros(labels.shape[0], device=labels.device)
    parts = hybrid_loss(ctc_nll, torch.zeros_like(ctc_nll), label_len,
                        mtl_alpha, num_real)
    metrics = dict(parts)
    metrics["att_acc"] = torch.zeros((), device=ctc_nll.device)
    metrics["num_real"] = num_real
    return parts["loss"], metrics


def make_train_step(model: ASRModel, config: Config, optimizer: Optimizer,
                    cmvn_stats=None) -> Callable:
    """``step_fn(state, batch) -> metrics``: draws SpecAugment's masks from
    ``state.generator``, takes the loss and its gradient, and updates the
    model's parameters in place. Metrics stay on the device; ``grad_norm``
    is the norm before clipping."""
    params = dict(model.named_parameters())
    fc = config.frontend

    def step_fn(state: TrainState, batch: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        audio = batch["audio"]
        draws = None
        if specaug_on(fc):
            frames = num_frames(audio.shape[1], fc.win_length, fc.hop_length)
            draws = draw_spec_augment(fc, audio.shape[0], frames,
                                      state.generator, audio.device)
        for p in params.values():
            p.grad = None
        loss, metrics = compute_loss(model, batch, config, spec_draws=draws,
                                     cmvn_stats=cmvn_stats, train=True)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        metrics["grad_norm"] = optimizer.update(params, grads,
                                                state.opt_state)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step_fn


def batch_to_device(b, device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader ``Batch`` as the step's tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(getattr(b, k))).to(device)
            for k in ("audio", "audio_len", "labels", "label_len")}
