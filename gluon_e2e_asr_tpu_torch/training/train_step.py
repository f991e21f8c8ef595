"""The training step: frontend -> encoder -> CTC loss and the attention
decoder's CE -> clip -> the optimizer (Adam, SGD or Adadelta).

Counterpart of ``gluon_e2e_asr_tpu/training/train_step.py``: the hybrid
objective mtl_alpha * CTC + (1 - mtl_alpha) * CE (label-smoothed,
padding- and pad-row-masked), or CTC alone at ``loss.mtl_alpha: 1.0``,
where the model has no decoder. The optimizer is the JAX package's
optax chain written out, because torch's defaults differ from it:

- the LR schedule is evaluated at the update count *before* the
  increment, so the first update of a warmup runs at LR 0
  (``optax.linear_schedule`` inside ``optax.join_schedules``, which
  hands the inverse-sqrt part ``count - warmup``);
- ``optax.clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
- Adam is optax's (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
  bias-corrected), with decoupled weight decay as ``optax.adamw``; SGD
  is ``optax.sgd`` with momentum 0.9; Adadelta is
  ``optax.inject_hyperparams(optax.adadelta)``, its eps in the state
  (``decay_opt_eps`` anneals it).

The values follow optax's float32 arithmetic. The step's randomness
(SpecAugment's masks, then the scheduled-sampling coins, then the
encoder dropout's masks) comes from an explicit ``torch.Generator`` in
the ``TrainState``; ``compute_loss`` takes all three as inputs.
Gradient accumulation splits the step as the JAX package does: a
micro-batch gradient pass (``make_grad_step``) and one update on the
group's row-weighted mean (``Accumulator``).

Data parallelism (``train.dp``, a ``World`` of ranks from
``parallel/mesh.py``) follows the JAX ``shard_map`` step: each rank
takes its contiguous block of the host batch's rows, normalizes its loss
by the global real-row count (every rank holds the whole host batch, so
it counts it without a collective), and the gradients, summed over the
ranks in one all-reduce before the clip, equal the single-device ones in
f32 (in bf16, within one rounding per rank of the weight gradients a
rank rounds before the sum).
Both values of ``train.dp_impl`` run this one implementation. The JAX
``pjit`` step is one global program whose draws are the single-device
draws; its ``shard_map`` step folds the shard index into each shard's
key. The port draws SpecAugment's masks, the coins and the dropout
masks for the global batch on every rank and keeps its own rows, which gives ``pjit``'s
semantics under either name: a step at world size n takes the draws of
world size 1, and the generators stay in step across ranks. The
``shard_map`` draws could not be matched anyway: the two frameworks'
random streams differ.
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
from gluon_e2e_asr_tpu_torch.ops.losses import (
    ce_label_smoothing_loss, hybrid_loss, make_decoder_io)
from gluon_e2e_asr_tpu_torch.parallel.mesh import (
    SINGLE, World, all_reduce_sum, shard_rows)

Params = Mapping[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip_norm), <family>)`` as
    the JAX ``make_optimizer`` builds it, with the warmup -> inverse-sqrt
    schedule. The families (``kind``) are ``adam`` / ``adamw``
    (``optax.adamw(schedule, weight_decay)``), ``sgd``
    (``optax.sgd(schedule, momentum=0.9)``) and ``adadelta``
    (``optax.inject_hyperparams(optax.adadelta)(schedule, rho, eps)``,
    whose eps lives in the state so that ``decay_opt_eps`` can anneal it
    and a checkpoint carries it). The state is a dict of plain values and
    tensors: its ``kind``, the update ``count`` and the family's slots."""

    SLOTS = {"adam": ("mu", "nu"), "sgd": ("trace",),
             "adadelta": ("e_g", "e_x")}

    def __init__(self, tc: TrainConfig):
        kind = "adam" if tc.optimizer == "adamw" else tc.optimizer
        if kind not in self.SLOTS:
            raise ValueError(f"unknown optimizer {tc.optimizer}")
        self.kind = kind
        self.lr_peak = float(tc.learning_rate)
        self.warmup = int(tc.warmup_steps)
        self.weight_decay = float(tc.weight_decay)
        self.clip = float(tc.grad_clip_norm)
        f32 = np.float32
        self.rho = float(f32(tc.adadelta_rho))
        self.one_minus_rho = float(f32(1.0) - f32(tc.adadelta_rho))
        self.eps = float(f32(tc.adadelta_eps))

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
        state: Dict[str, Any] = {"kind": self.kind, "count": 0}
        for slot in self.SLOTS[self.kind]:
            state[slot] = {k: torch.zeros_like(p) for k, p in params.items()}
        if self.kind == "adadelta":
            state["eps"] = self.eps
        return state

    def _direction(self, k: str, g: torch.Tensor, p: torch.Tensor,
                   state: Dict[str, Any], count: int) -> torch.Tensor:
        """The family's update of one parameter before the -lr scale;
        advances its slots."""
        if self.kind == "sgd":
            state["trace"][k] = g + 0.9 * state["trace"][k]
            return state["trace"][k]
        if self.kind == "adadelta":
            eps = state["eps"]
            e_g = self.one_minus_rho * (g * g) + self.rho * state["e_g"][k]
            upd = torch.sqrt(state["e_x"][k] + eps) / torch.sqrt(e_g + eps) * g
            state["e_g"][k] = e_g
            state["e_x"][k] = (self.one_minus_rho * (upd * upd)
                               + self.rho * state["e_x"][k])
            return upd
        c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count + 1))
        c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count + 1))
        mu = (1.0 - B1) * g + B1 * state["mu"][k]
        nu = (1.0 - B2) * (g * g) + B2 * state["nu"][k]
        state["mu"][k], state["nu"][k] = mu, nu
        upd = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
        if self.weight_decay:
            upd = upd + self.weight_decay * p
        return upd

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               state: Dict[str, Any]) -> torch.Tensor:
        """Apply one update to ``params`` in place and advance ``state``.
        Returns the global norm of ``grads`` before clipping."""
        if state.get("kind", "adam") != self.kind:
            raise ValueError(f"an optimizer state of {state.get('kind')!r} "
                             f"given to {self.kind!r}")
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                              for g in grads.values()))
        count = state["count"]
        lr = self.lr(count)
        for k, p in params.items():
            g = grads[k].float()
            if self.clip > 0:
                g = torch.where(norm < self.clip, g, (g / norm) * self.clip)
            p.add_(self._direction(k, g, p, state, count) * (-lr))
        state["count"] = count + 1
        return norm


def make_optimizer(config: Config) -> Optimizer:
    return Optimizer(config.train)


def decay_opt_eps(opt_state: Dict[str, Any], factor: float):
    """``(new_state, old_eps, new_eps)``: ``opt_state`` with its eps (the
    adadelta family's) multiplied by ``factor`` in f32 and floored at the
    f32 tiny value (an eps annealed to 0 turns adadelta's sqrt(acc + eps)
    ratio into 0/0), as the JAX ``decay_opt_eps``; ``(opt_state, None,
    None)`` for a family without an eps in its state."""
    if "eps" not in opt_state:
        return opt_state, None, None
    f32 = np.float32
    old = f32(opt_state["eps"])
    new = np.maximum(old * f32(factor), f32(np.finfo(f32).tiny))
    return dict(opt_state, eps=float(new)), float(old), float(new)


@dataclass
class TrainState:
    step: int
    opt_state: Dict[str, Any]
    generator: torch.Generator  # SpecAugment, the coins, then dropout


def create_train_state(config: Config, model: ASRModel, optimizer: Optimizer,
                       device: torch.device = torch.device("cpu")
                       ) -> TrainState:
    """A fresh state: ``model``'s parameters drawn on the CPU from
    ``train.seed`` (the encoder's first, then the decoder's) and moved to
    ``device`` (in place), a zero optimizer state and the step's
    generator."""
    seed = int(config.train.seed)
    gen = torch.Generator().manual_seed(seed)
    model.encoder.reset_parameters(gen)
    if model.use_decoder:
        model.decoder.reset_parameters(gen)
    model.to(device)
    return TrainState(step=0,
                      opt_state=optimizer.init(dict(model.named_parameters())),
                      generator=torch.Generator().manual_seed(seed + 1))


def ss_prob(config: Config, step: int) -> float:
    """The scheduled-sampling probability of the update made at ``step``
    updates: ``loss.scheduled_sampling``, ramped linearly from 0 over
    ``loss.scheduled_sampling_warmup_steps`` (f32, as the JAX step
    computes it)."""
    lc = config.loss
    p = float(lc.scheduled_sampling)
    warmup = int(lc.scheduled_sampling_warmup_steps)
    if p > 0.0 and warmup > 0:
        f32 = np.float32
        p = float(f32(p) * min(f32(step) / f32(warmup), f32(1.0)))
    return p


def draw_coins(config: Config, step: int, batch: int, max_labels: int,
               generator: torch.Generator, device: torch.device):
    """The scheduled-sampling coins [L+1, B] bool (True: feed the
    previous step's argmax), row 0 False; None when the probability is 0
    (no draw is taken from ``generator`` then)."""
    p = ss_prob(config, step)
    if p <= 0.0:
        return None
    coins = torch.rand(max_labels + 1, batch, generator=generator) < p
    coins[0] = False
    return coins.to(device)


def draw_dropout(config: Config, model: ASRModel, batch: int, frames: int,
                 generator: torch.Generator, device: torch.device):
    """The encoder dropout's keep masks, one [B, T_l, 2H] bool per BiLSTM
    layer (keep with probability 1 - ``model.enc_dropout``, the flax
    ``nn.Dropout`` of each layer's output); None when the rate is 0 (no
    draw is taken from ``generator`` then). ``frames``: the features'."""
    p = float(config.model.enc_dropout)
    if p <= 0.0:
        return None
    keep = 1.0 - p
    width = 2 * config.model.enc_hidden
    return [(torch.rand(batch, t, width, generator=generator) < keep)
            .to(device) for t in model.encoder.layer_frames(frames)]


def compute_loss(model: ASRModel, batch: Mapping[str, torch.Tensor],
                 config: Config, *, spec_draws=None, coins=None,
                 drop_masks=None, cmvn_stats=None, train: bool = True,
                 num_real=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and the joint loss of ``batch`` (tensors on the model's
    device: audio, audio_len, labels, label_len), normalized by the real
    (non-pad) row count: ``batch``'s own, or ``num_real``, the global
    batch's, when ``batch`` is one rank's rows (the loss and ``att_acc``
    are then this rank's share of the global ones). SpecAugment's masks
    (``spec_draws``), the scheduled-sampling coins [L+1,B] and the
    encoder dropout's keep masks (``drop_masks``) are inputs.
    A model without the attention decoder has an attention part of 0."""
    feats, feat_len = frontend_apply(
        config.frontend, batch["audio"], batch["audio_len"], train=train,
        spec_draws=spec_draws, cmvn_stats=cmvn_stats)
    labels, label_len = batch["labels"], batch["label_len"]
    if num_real is None:
        num_real = (batch["audio_len"] > 0).sum()
    tokens_in = None
    if model.use_decoder:
        tokens_in, targets, tgt_mask = make_decoder_io(
            labels, label_len, model.sos_id, model.eos_id)
    out = model(feats, feat_len, tokens_in, coins if train else None,
                drop_masks=drop_masks if train else None)
    mtl_alpha = config.loss.mtl_alpha
    if mtl_alpha > 0.0:
        ctc_nll = ctc_loss(out["ctc_logits"], out["enc_len"], labels,
                           label_len, blank_id=0)
    else:
        ctc_nll = torch.zeros(labels.shape[0], device=labels.device)
    att_acc = torch.zeros((), device=labels.device)
    if model.use_decoder:
        # Pad rows are masked out of the attention CE.
        row_mask = (batch["audio_len"] > 0).float()[:, None]
        att_ce, acc = ce_label_smoothing_loss(
            out["att_logits"], targets, tgt_mask * row_mask,
            config.loss.label_smoothing)
        # The real rows of the global batch: row_mask's sum at one rank.
        att_acc = (acc * row_mask[:, 0]).sum() / torch.clamp(
            num_real.float(), min=1.0)
    else:
        att_ce = torch.zeros_like(ctc_nll)
    parts = hybrid_loss(ctc_nll, att_ce, label_len, mtl_alpha, num_real)
    metrics = dict(parts)
    metrics["att_acc"] = att_acc
    metrics["num_real"] = num_real
    return parts["loss"], metrics


SUMMED = ("loss", "loss_ctc", "loss_att", "att_acc")


def make_grad_step(model: ASRModel, config: Config, cmvn_stats=None,
                   world: World = SINGLE) -> Callable:
    """``grad_fn(state, batch) -> (grads, metrics)``, the JAX
    ``make_grad_step``'s pass without its sum over the ranks: draws
    SpecAugment's masks, then the scheduled-sampling coins, then the
    encoder dropout's masks for ``batch`` (the whole host batch, tensors
    on any device) from ``state.generator``, moves ``world``'s rows of it
    to the model's device and takes the loss and its gradient. ``grads``
    and the ``SUMMED`` metrics are this rank's share of the global
    batch's (their sums over the ranks are the global ones); ``num_real``
    is the global batch's real rows. The parameters and ``state.step``
    are left as they are."""
    if config.train.dp_impl not in ("shard_map", "pjit"):
        raise ValueError(f"unknown train.dp_impl {config.train.dp_impl!r}")
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    fc = config.frontend

    def rows(x):
        return x if world.size == 1 else shard_rows(x, world.rank, world.size)

    def grad_fn(state: TrainState, batch: Mapping[str, torch.Tensor]):
        audio = batch["audio"]
        frames = num_frames(audio.shape[1], fc.win_length, fc.hop_length)
        draws = None
        if specaug_on(fc):
            draws = draw_spec_augment(fc, audio.shape[0], frames,
                                      state.generator, dev)
            draws = type(draws)(*(None if d is None else rows(d)
                                  for d in draws))
        coins = None
        if model.use_decoder:
            coins = draw_coins(config, state.step, audio.shape[0],
                               batch["labels"].shape[1], state.generator,
                               dev)
            if coins is not None:
                coins = rows(coins.T).T
        masks = draw_dropout(config, model, audio.shape[0], frames,
                             state.generator, dev)
        if masks is not None:
            masks = [rows(m) for m in masks]
        num_real = (torch.as_tensor(batch["audio_len"]) > 0).sum().to(dev)
        local = {k: torch.as_tensor(rows(v)).to(dev)
                 for k, v in batch.items()}
        for p in params.values():
            p.grad = None
        loss, metrics = compute_loss(model, local, config, spec_draws=draws,
                                     coins=coins, drop_masks=masks,
                                     cmvn_stats=cmvn_stats, train=True,
                                     num_real=num_real)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        return grads, {k: v.detach() for k, v in metrics.items()}

    return grad_fn


def make_train_step(model: ASRModel, config: Config, optimizer: Optimizer,
                    cmvn_stats=None, world: World = SINGLE) -> Callable:
    """``step_fn(state, batch) -> metrics``: ``make_grad_step``'s pass,
    the gradients and the loss parts summed over the ranks in one
    all-reduce, and one update of the model's parameters in place.
    Metrics stay on the device; ``grad_norm`` is the global norm before
    clipping."""
    params = dict(model.named_parameters())
    grad_fn = make_grad_step(model, config, cmvn_stats, world)

    def step_fn(state: TrainState, batch: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        grads, metrics = grad_fn(state, batch)
        all_reduce_sum([*grads.values(), *(metrics[k] for k in SUMMED)],
                       world)
        metrics["grad_norm"] = optimizer.update(params, grads,
                                                state.opt_state)
        state.step += 1
        return metrics

    return step_fn


class Accumulator:
    """Gradient accumulation (``train.accum_grad_steps``), the JAX
    ``make_grad_step`` / ``accumulate_grads`` / ``make_apply_step``:
    ``add`` takes a micro-batch's gradients weighted by its global
    real-row count n (the loss is a mean over those rows, so sum(n_i g_i)
    / sum(n_i) is the gradient of the combined batch); ``apply`` sums
    the group over the ranks in one all-reduce, divides by the group's
    rows and takes one optimizer update (the clip sees the combined
    mean), advancing ``state.step``, and returns the group's metrics."""

    def __init__(self, model: ASRModel, optimizer: Optimizer,
                 world: World = SINGLE):
        self.params = dict(model.named_parameters())
        self.optimizer, self.world = optimizer, world
        self.grads = self.sums = self.n = None
        self.micro = 0

    def add(self, grads: Params, metrics: Mapping[str, torch.Tensor]) -> None:
        # As in JAX: the gradients weighted by max(n, 1), the metrics and
        # the group's rows by n.
        n = metrics["num_real"].float()
        weight = torch.clamp(n, min=1.0)
        grads = {k: g * weight for k, g in grads.items()}
        sums = {k: metrics[k] * n for k in SUMMED}
        if self.grads is None:
            self.grads, self.sums, self.n = grads, sums, n
        else:
            self.grads = {k: self.grads[k] + g for k, g in grads.items()}
            self.sums = {k: self.sums[k] + v for k, v in sums.items()}
            self.n = self.n + n
        self.micro += 1

    def apply(self, state: TrainState) -> Dict[str, torch.Tensor]:
        all_reduce_sum([*self.grads.values(), *self.sums.values()],
                       self.world)
        n = torch.clamp(self.n, min=1.0)
        scale = 1.0 / n
        grads = {k: g * scale for k, g in self.grads.items()}
        metrics = {k: v / n for k, v in self.sums.items()}
        metrics["grad_norm"] = self.optimizer.update(self.params, grads,
                                                     state.opt_state)
        metrics["num_real"] = self.n
        state.step += 1
        self.grads = self.sums = self.n = None
        self.micro = 0
        return metrics


def batch_tensors(b) -> Dict[str, torch.Tensor]:
    """A loader ``Batch`` as the step's tensors, on the host."""
    return {k: torch.from_numpy(np.asarray(getattr(b, k)))
            for k in ("audio", "audio_len", "labels", "label_len")}


def batch_to_device(b, device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader ``Batch`` as the step's tensors on ``device``."""
    return {k: v.to(device) for k, v in batch_tensors(b).items()}
