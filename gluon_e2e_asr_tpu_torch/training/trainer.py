"""Datasets, vocab and the training loop.

Counterpart of ``gluon_e2e_asr_tpu/training/trainer.py``:
``build_datasets`` and ``Trainer``, the host epoch loop around the
train step (hybrid CTC/attention, or CTC alone at ``loss.mtl_alpha:
1.0``). The vocab, manifests, bucketed sampler and loader are the
port's copies of the JAX package's (``data/``). ``metrics.jsonl`` gets
the same ``train`` and ``epoch`` lines. The dev evaluation at each
epoch's end follows ``decode.method``, as the JAX trainer's does: the
batched beam search for ``beam`` / ``ctc_beam``, greedy CTC otherwise.
Options whose code paths are not ported raise and name ROADMAP.md.

With ``train.dp`` the trainer runs on every rank of a ``World``
(``parallel/mesh.py``): every rank loads every batch and runs every step
on its rows (``training/train_step.py``); every bucket's batch size must
divide the world size. The dev evaluation shards each batch over the
ranks where every dev bucket divides and otherwise decodes it whole on
every rank (a ``dp_eval_fallback`` line). Rank 0 alone writes
``metrics.jsonl`` and the checkpoints.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import Config
from gluon_e2e_asr_tpu_torch.data.loader import DataLoader
from gluon_e2e_asr_tpu_torch.data.manifest import (
    Utterance,
    build_librispeech_manifest,
    build_synthetic_manifest,
    load_manifest,
)
from gluon_e2e_asr_tpu_torch.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr_tpu_torch.data.tokenizer import build_tokenizer
from gluon_e2e_asr_tpu_torch.decoding.beam import make_beam_decoder
from gluon_e2e_asr_tpu_torch.decoding.greedy import ids_to_texts, make_greedy_decoder
from gluon_e2e_asr_tpu_torch.eval.metrics import cer, wer
from gluon_e2e_asr_tpu_torch.models.asr import build_model
from gluon_e2e_asr_tpu_torch.parallel.mesh import (
    SINGLE, World, check_replicated, init_data_parallel)
from gluon_e2e_asr_tpu_torch.training.checkpoint import save_train_checkpoint
from gluon_e2e_asr_tpu_torch.training.train_step import (
    batch_tensors, create_train_state, make_optimizer, make_train_step)
from gluon_e2e_asr_tpu_torch.utils.logging import JsonlLogger


def build_datasets(config: Config) -> Tuple[List[Utterance], List[Utterance]]:
    dc = config.data
    if dc.dataset == "synthetic":
        # (--set parses the literal "none" to None; both mean no split.)
        if dc.synth_split not in ("none", "sentence", None):
            raise ValueError(f"unknown data.synth_split {dc.synth_split!r}")
        disjoint = dc.synth_split == "sentence"
        train = build_synthetic_manifest(
            dc.synth_num_train, dc.synth_seed, dc.synth_min_tokens,
            dc.synth_max_tokens, prefix="train", text_mode=dc.synth_text,
            noise=dc.synth_noise, jitter=dc.synth_jitter,
            split="train" if disjoint else "all",
        )
        dev = build_synthetic_manifest(
            dc.synth_num_dev, dc.synth_seed + 1, dc.synth_min_tokens,
            dc.synth_max_tokens, prefix="dev", text_mode=dc.synth_text,
            noise=dc.synth_noise, jitter=dc.synth_jitter,
            split="dev" if disjoint else "all",
        )
        return train, dev
    if dc.dataset == "librispeech":
        if dc.train_manifest:
            return load_manifest(dc.train_manifest), load_manifest(dc.dev_manifest)
        train = build_librispeech_manifest(dc.data_dir, "train-clean-100")
        dev = build_librispeech_manifest(dc.data_dir, "dev-clean")
        return train, dev
    raise ValueError(f"unknown dataset {dc.dataset}")


def _refuse_unported(config: Config) -> None:
    """Raise for the training options whose code paths are not ported."""
    tc = config.train
    unported = [
        (tc.accum_grad_steps > 1, "train.accum_grad_steps > 1: gradient "
                                  "accumulation (ROADMAP.md)"),
        (tc.eps_decay > 0 or tc.plateau_restore_best,
         "train.eps_decay / train.plateau_restore_best: plateau annealing "
         "(ROADMAP.md)"),
        (tc.early_stop_patience > 0, "train.early_stop_patience: early "
                                     "stopping (ROADMAP.md)"),
        (tc.ckpt_every_steps > 0, "train.ckpt_every_steps: mid-epoch "
                                  "checkpoints, which exist for resume "
                                  "(ROADMAP.md)"),
        (bool(tc.profile_dir), "train.profile_dir: profiling from the "
                               "trainer (ROADMAP.md)"),
    ]
    for on, what in unported:
        if on:
            raise NotImplementedError(f"{what} is not ported yet")


def _indivisible(specs, world: World) -> List[int]:
    """The bucket batch sizes (with ``data.dynamic_batch`` they differ from
    ``data.batch_size``) that do not split over the world's ranks."""
    return sorted({s.batch_size for s in specs if s.batch_size % world.size})


def check_divisible(specs, world: World, what: str) -> None:
    """Raise unless every bucket's batch size divides the world size."""
    bad = _indivisible(specs, world)
    if bad:
        raise ValueError(
            f"{what} needs every bucket batch size divisible by the world "
            f"size ({world.size}); got {bad}: adjust data.batch_size / "
            "data.bucket_bounds_sec or disable data.dynamic_batch")


def eval_world(specs, world: World, logger) -> World:
    """The world the dev evaluation shards over: ``world`` where every dev
    bucket's batch size divides its size, else a single process (each
    rank decodes the whole batch), logged as ``dp_eval_fallback``."""
    bad = _indivisible(specs, world)
    if not bad:
        return world
    logger.log({
        "event": "dp_eval_fallback",
        "reason": "dev bucket batch sizes not divisible by the world size",
        "bad_batch_sizes": bad,
        "devices": world.size,
    })
    return SINGLE


class Trainer:
    def __init__(self, config: Config, workdir: str = ".",
                 device: torch.device = torch.device("cpu")):
        """With ``train.dp`` the trainer joins the default process group's
        ranks (``init_data_parallel``; a CUDA ``device`` then means
        ``cuda:LOCAL_RANK``); without it, it is a single process."""
        _refuse_unported(config)
        self.config = config
        self.workdir = workdir
        device = torch.device(device)
        world = SINGLE
        if config.train.dp:
            world = init_data_parallel(device.type)
            if device.type == "cuda":
                if device.index not in (None, world.local_rank):
                    raise ValueError(
                        f"device {device} with train.dp: rank {world.rank} "
                        f"runs on cuda:{world.local_rank} (LOCAL_RANK)")
                device = torch.device("cuda", world.local_rank)
        self.device = device
        self.world = world
        # Rank 0 writes the metrics.
        self.logger = JsonlLogger(
            os.path.join(workdir, config.train.metrics_path)
            if world.is_main else None, also_stdout=world.is_main)

        t_walk = time.perf_counter()
        self.train_utts, self.dev_utts = build_datasets(config)
        self.logger.log({
            "event": "datasets",
            "manifest_walk_s": round(time.perf_counter() - t_walk, 2),
            "train_utts": len(self.train_utts),
            "dev_utts": len(self.dev_utts),
        })
        self.tokenizer = build_tokenizer(config, (u.text for u in self.train_utts))
        specs = make_bucket_specs(
            config.data.bucket_bounds_sec, config.data.sample_rate,
            config.data.batch_size, config.data.max_label_len,
            config.frontend.hop_length, config.data.dynamic_batch,
        )
        sp = tuple(config.data.speed_perturb or ())
        if sp and min(sp) <= 0:
            raise ValueError(f"data.speed_perturb factors must be > 0: {sp}")
        self.sampler = BucketSampler(
            self.train_utts, specs, config.data.sample_rate,
            seed=config.train.seed, shuffle=config.data.shuffle,
            drop_last=config.data.drop_last,
            sortagrad_epochs=config.data.sortagrad_epochs,
            speed_perturb=sp, perturb_seed=config.train.seed,
            static_placement=config.data.static_placement,
        )
        self.loader = DataLoader(
            self.train_utts, self.sampler, self.tokenizer,
            config.data.sample_rate, speed_perturb=sp,
            perturb_seed=config.train.seed,
            transfer_dtype=config.data.transfer_dtype,
        )
        self.dev_loader = DataLoader(
            self.dev_utts,
            BucketSampler(self.dev_utts, specs, config.data.sample_rate,
                          seed=0, shuffle=False),
            self.tokenizer, config.data.sample_rate,
            transfer_dtype=config.data.transfer_dtype,
        )
        for name, s, utts in (("train", self.sampler, self.train_utts),
                              ("dev", self.dev_loader.sampler, self.dev_utts)):
            if s.skipped:
                self.logger.log({
                    "event": "data_skipped", "split": name,
                    "skipped": len(s.skipped), "total": len(utts),
                    "hint": "utterances exceeding every bucket bound "
                            "(duration or label budget) are dropped",
                })

        check_divisible(specs, world, "train.dp")
        if config.train.dp:
            self.logger.log({"event": "data_parallel",
                             "world_size": world.size,
                             "dp_impl": config.train.dp_impl})

        self.cmvn_stats = None
        if config.frontend.cmvn == "global":
            path = config.frontend.cmvn_stats_path
            if not path or not os.path.exists(path):
                raise FileNotFoundError(
                    "frontend.cmvn == 'global' requires cmvn_stats_path "
                    f"(generate with tools/compute_cmvn.py), got: {path!r}")
            blob = np.load(path)
            self.cmvn_stats = tuple(
                torch.as_tensor(blob[k], dtype=torch.float32,
                                device=self.device) for k in ("mean", "std"))

        self.model = build_model(config, self.tokenizer.vocab_size, train=True,
                                 sos_id=self.tokenizer.sos_id,
                                 eos_id=self.tokenizer.eos_id)
        self.optimizer = make_optimizer(config)
        self.state = create_train_state(config, self.model, self.optimizer,
                                        self.device)
        # Each rank drew the parameters from train.seed.
        check_replicated(list(self.model.parameters()), world)
        self.train_step = make_train_step(self.model, config, self.optimizer,
                                          self.cmvn_stats, world)
        # The dev evaluation's decoder follows decode.method (a CTC-only
        # model with method beam raises here, as in the JAX trainer).
        ew = eval_world(self.dev_loader.sampler.specs, world, self.logger)
        self.greedy = self._beam = None
        if config.decode.method in ("beam", "ctc_beam"):
            self._beam = make_beam_decoder(self.model, config, self.tokenizer,
                                           self.cmvn_stats, mesh=ew,
                                           device=self.device)
        else:
            self.greedy = make_greedy_decoder(self.model, config,
                                              self.cmvn_stats, self.device,
                                              mesh=ew)
        self.best_wer = float("inf")

    def train(self) -> Dict[str, float]:
        tc = self.config.train
        step = self.state.step
        n_chips = self.world.size
        final: Dict[str, float] = {}
        for epoch in range(tc.num_epochs):
            t_epoch = time.perf_counter()
            utts_done, tokens_done = 0, 0
            real_samples, padded_samples = 0, 0
            window_t0, window_utts, window_tokens = time.perf_counter(), 0, 0
            stopped_at = -1
            prefetch = self.loader.prefetch_epoch(
                epoch, depth=self.config.data.prefetch_depth)
            try:
                for batch_idx, b in prefetch:
                    if 0 < tc.max_steps <= step:
                        stopped_at = batch_idx
                        break
                    metrics = self.train_step(self.state, batch_tensors(b))
                    step = self.state.step
                    utts_done += b.num_real
                    real_samples += int(b.audio_len.sum())
                    padded_samples += int(b.audio.shape[0] * b.audio.shape[1])
                    window_utts += b.num_real
                    window_tokens += int(b.label_len.sum())
                    tokens_done += int(b.label_len.sum())
                    if step % tc.log_every_steps == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        dt = time.perf_counter() - window_t0
                        self.logger.log({
                            "event": "train",
                            "step": step,
                            "epoch": epoch,
                            "bucket": b.bucket,
                            "loss": round(m["loss"], 5),
                            "loss_ctc": round(m["loss_ctc"], 5),
                            "loss_att": round(m["loss_att"], 5),
                            "att_acc": round(m["att_acc"], 4),
                            "grad_norm": round(m["grad_norm"], 4),
                            "utt_per_sec_per_chip": round(
                                window_utts / max(dt, 1e-9) / n_chips, 2),
                            "tokens_per_sec": round(
                                window_tokens / max(dt, 1e-9), 1),
                        })
                        window_t0, window_utts, window_tokens = (
                            time.perf_counter(), 0, 0)
            finally:
                prefetch.close()
            train_time = time.perf_counter() - t_epoch
            if stopped_at >= 0:
                # max_steps hit mid-epoch: checkpoint with the position in
                # the epoch instead of marking the epoch complete.
                self._checkpoint(epoch, None, batches_done=stopped_at)
                break
            dev = self.evaluate()
            epoch_time = time.perf_counter() - t_epoch
            rec = {
                "event": "epoch",
                "epoch": epoch,
                "step": step,
                "epoch_time_s": round(epoch_time, 2),
                "prefetch_occupancy": round(
                    1.0 - prefetch.consumer_wait_s / max(train_time, 1e-9), 4),
                "utt_per_sec_per_chip": round(
                    utts_done / max(epoch_time, 1e-9) / n_chips, 2),
                "tokens_per_sec": round(tokens_done / max(epoch_time, 1e-9), 1),
                "pad_waste": round(
                    1.0 - real_samples / max(padded_samples, 1), 4),
                **{k: round(v, 4) for k, v in dev.items()},
            }
            self.logger.log(rec)
            is_best = dev["dev_wer"] < self.best_wer
            if is_best:
                self.best_wer = dev["dev_wer"]
            self._checkpoint(epoch, is_best, dev_wer=dev["dev_wer"])
            final = rec
            if 0 < tc.max_steps <= step:
                break
        return final

    def _checkpoint(self, epoch: int, is_best: Optional[bool],
                    batches_done: int = -1,
                    dev_wer: Optional[float] = None) -> Optional[str]:
        """Rank 0 writes the checkpoint; the others return None."""
        if not self.world.is_main:
            return None
        meta = {
            "epoch": epoch,
            "batches_done": batches_done,
            "config_hash": self.config.fingerprint(),
            "vocab": self.tokenizer.to_json(),
            "vocab_hash": self.tokenizer.fingerprint(),
            "best_wer": self.best_wer,
        }
        if dev_wer is not None:
            meta["dev_wer"] = float(dev_wer)
        t_save = time.perf_counter()
        tc = self.config.train
        path = save_train_checkpoint(
            os.path.join(self.workdir, tc.ckpt_dir),
            self.model.state_dict(), self.state.opt_state, self.state.step,
            meta, self.cmvn_stats, keep=tc.keep_ckpts, is_best=bool(is_best),
            keep_policy=tc.keep_policy)
        self.logger.log({
            "event": "ckpt_io",
            "epoch": epoch,
            "save_s": round(time.perf_counter() - t_save, 3),
            "best": bool(is_best),
        })
        return path

    def evaluate(self) -> Dict[str, float]:
        """Decode the dev set (beam or greedy, as ``decode.method`` says)
        and score WER/CER."""
        refs, hyps = [], []
        by_id = {u.utt_id: u for u in self.dev_utts}
        for b in self.dev_loader.epoch(0):
            if self._beam is not None:
                texts, _ = self._beam(b.audio, b.audio_len)
            else:
                ids, lens = self.greedy(b.audio, b.audio_len)
                texts = ids_to_texts(ids.cpu().numpy(), lens.cpu().numpy(),
                                     self.tokenizer)
            for row, utt_id in enumerate(b.utt_ids):
                refs.append(by_id[utt_id].text)
                hyps.append(texts[row])
        return {"dev_wer": wer(refs, hyps), "dev_cer": cer(refs, hyps)}
