"""External-LM training CLI: ``python -m gluon_e2e_asr_tpu_torch.train_lm
--config <yaml> --workdir <dir> [--set KEY=VAL ...] [--device cuda]``.

Counterpart of ``gluon_e2e_asr_tpu/train_lm.py``: trains the
shallow-fusion LSTM LM (``models/lm.py``) on the transcript text of the
configured dataset's train manifest, plus ``lm.extra_text`` if given
(text only, no audio). Every batch pads to [lm.batch_size, lm.max_len]
with len-0 rows; the order is a numpy ``default_rng(lm.seed)`` shuffle
of the texts, as in JAX. The step is the JAX optax chain written out by
``training/train_step.py::Optimizer``: the global-norm clip at
``lm.grad_clip_norm``, then AdamW (optax's default weight decay 1e-4,
which the JAX CLI keeps) on the warmup -> inverse-sqrt schedule, on the
masked mean NLL.

Writes ``lm_metrics.jsonl`` lines {event: lm_epoch, epoch, loss,
dev_ppl}, saves the best-dev-perplexity checkpoint to
``<workdir>/<lm.ckpt_path>`` (``torch.save`` + the JSON sidecar with the
architecture and the vocab, which the beam checks before fusing) and
prints one ``lm_done`` line.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import (
    Config, TrainConfig, apply_overrides, load_config)
from gluon_e2e_asr_tpu_torch.data.tokenizer import build_tokenizer
from gluon_e2e_asr_tpu_torch.models.lm import LSTMLM, build_lm, save_lm
from gluon_e2e_asr_tpu_torch.training.train_step import Optimizer
from gluon_e2e_asr_tpu_torch.utils.logging import JsonlLogger


def gather_texts(config: Config) -> tuple[List[str], List[str], List[str]]:
    """(vocab_texts, train_texts, dev_texts) from the manifests. The
    vocabulary is built from the manifest transcripts only, as the ASR
    trainer builds it, so that the fingerprints match at fusion time;
    ``lm.extra_text`` lines join the training stream only."""
    from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets

    train_utts, dev_utts = build_datasets(config)
    vocab_texts = [u.text for u in train_utts]
    train = list(vocab_texts)
    dev = [u.text for u in dev_utts]
    if config.lm.extra_text:
        with open(config.lm.extra_text) as f:
            train += [ln.strip() for ln in f if ln.strip()]
    return vocab_texts, train, dev


def make_batches(texts: List[str], tokenizer, max_len: int, batch_size: int,
                 rng: np.random.Generator | None):
    """Yield (tokens_in [B,L], targets [B,L], lens [B]) int32 batches:
    tokens_in = [sos, y_1..], targets = [y_1.., eos], lens the valid
    positions (tokens + 1, capped at max_len). A short last batch is
    padded with len-0 rows."""
    order = np.arange(len(texts))
    if rng is not None:
        rng.shuffle(order)
    B, L = batch_size, max_len
    for start in range(0, len(order), B):
        idx = order[start: start + B]
        tokens_in = np.zeros((B, L), np.int32)
        targets = np.zeros((B, L), np.int32)
        lens = np.zeros((B,), np.int32)
        for row, j in enumerate(idx):
            ids = tokenizer.encode(texts[j])[: L - 1]
            n = len(ids) + 1
            tokens_in[row, :n] = [tokenizer.sos_id] + ids
            targets[row, :n] = ids + [tokenizer.eos_id]
            lens[row] = n
        yield tokens_in, targets, lens


def _nll(model: LSTMLM, tokens_in, targets, lens):
    """(masked mean NLL, token count) of a batch."""
    logp = torch.log_softmax(model(tokens_in, lens), dim=-1)
    nll = -torch.gather(logp, 2, targets.long()[..., None])[..., 0]
    mask = (torch.arange(tokens_in.shape[1], device=lens.device)[None, :]
            < lens[:, None])
    count = torch.clamp(mask.sum(), min=1)
    return (nll * mask).sum() / count, count


def make_lm_step(model: LSTMLM, lc):
    """(optimizer, train_step, eval_step). ``train_step(opt_state,
    tokens_in, targets, lens)`` updates the model's parameters in place
    and returns (loss, count); ``eval_step(tokens_in, targets, lens)``
    returns (summed NLL, count). Inputs are tensors on the model's
    device. The optimizer is ``optax.chain(clip_by_global_norm(
    lc.grad_clip_norm), adamw(schedule))`` at optax's default weight
    decay, 1e-4, which the JAX CLI keeps."""
    opt = Optimizer(TrainConfig(
        optimizer="adamw", learning_rate=lc.learning_rate,
        warmup_steps=lc.warmup_steps, grad_clip_norm=lc.grad_clip_norm,
        weight_decay=1e-4))
    params = dict(model.named_parameters())

    def train_step(opt_state, tokens_in, targets, lens):
        model.zero_grad(set_to_none=True)
        loss, count = _nll(model, tokens_in, targets, lens)
        loss.backward()
        opt.update(params, {k: p.grad for k, p in params.items()}, opt_state)
        return loss.detach(), count

    @torch.no_grad()
    def eval_step(tokens_in, targets, lens):
        loss, count = _nll(model, tokens_in, targets, lens)
        return loss * count, count

    return opt, train_step, eval_step


def _tensors(device, *arrays):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def dev_perplexity(eval_step, texts, tokenizer, lc, device) -> float:
    total, count = 0.0, 0
    for batch in make_batches(texts, tokenizer, lc.max_len, lc.batch_size,
                              rng=None):
        s, c = eval_step(*_tensors(device, *batch))
        total += float(s)
        count += int(c)
    return float(np.exp(total / max(count, 1)))


def train_lm(config: Config, workdir: str = ".",
             device: torch.device = torch.device("cpu")) -> dict:
    lc = config.lm
    vocab_texts, train_texts, dev_texts = gather_texts(config)
    # the ASR trainer's construction rule, so that an LM of the same
    # config shares the ASR vocab bit for bit (the beam checks it)
    tokenizer = build_tokenizer(config, vocab_texts)
    model = build_lm(config, tokenizer.vocab_size)
    model.reset_parameters(torch.Generator().manual_seed(lc.seed))
    model.to(device).train()
    opt, train_step, eval_step = make_lm_step(model, lc)
    opt_state = opt.init(dict(model.named_parameters()))
    logger = JsonlLogger(os.path.join(workdir, "lm_metrics.jsonl"))

    ckpt = os.path.join(workdir, lc.ckpt_path)
    best_ppl = float("inf")
    rng = np.random.default_rng(lc.seed)
    last_loss = float("nan")
    for epoch in range(lc.num_epochs):
        tot, cnt = 0.0, 0
        for batch in make_batches(train_texts, tokenizer, lc.max_len,
                                  lc.batch_size, rng):
            loss, count = train_step(opt_state, *_tensors(device, *batch))
            tot += float(loss) * int(count)
            cnt += int(count)
        last_loss = tot / max(cnt, 1)
        ppl = dev_perplexity(eval_step, dev_texts, tokenizer, lc, device)
        logger.log({"event": "lm_epoch", "epoch": epoch,
                    "loss": round(last_loss, 4), "dev_ppl": round(ppl, 3)})
        if ppl < best_ppl:
            best_ppl = ppl
            save_lm(ckpt, model.state_dict(), {
                "vocab_size": tokenizer.vocab_size,
                "embed_dim": lc.embed_dim,
                "hidden": lc.hidden,
                "layers": lc.layers,
                "vocab": tokenizer.to_json(),
                "dev_ppl": ppl,
                "epoch": epoch,
            })
    logger.close()
    return {"ckpt": ckpt, "best_dev_ppl": best_ppl, "final_loss": last_loss}


def main(argv=None):
    p = argparse.ArgumentParser(description="LM training (shallow-fusion "
                                "LSTM LM, PyTorch port)")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--workdir", type=str, default=".")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda or cpu")
    args = p.parse_args(argv)
    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the LM's f32 products
    result = train_lm(config, workdir=args.workdir, device=device)
    print(json.dumps({"event": "lm_done", **result}, default=float))
    return result


if __name__ == "__main__":
    main()
