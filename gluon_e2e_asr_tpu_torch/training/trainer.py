"""Datasets, vocab and the training loop.

Counterpart of ``gluon_e2e_asr_tpu/training/trainer.py``:
``build_datasets`` and ``Trainer``, the host epoch loop around the
train step (hybrid CTC/attention, or CTC alone at ``loss.mtl_alpha:
1.0``). The vocab, manifests, bucketed sampler and loader are the
port's copies of the JAX package's (``data/``). ``metrics.jsonl`` gets
the same ``train`` and ``epoch`` lines. The dev evaluation at each
epoch's end follows ``decode.method``, as the JAX trainer's does: the
batched beam search for ``beam`` / ``ctc_beam``, greedy CTC otherwise.
Every option of the JAX trainer runs: ``maybe_resume`` (exact mid-epoch
resume from the newest checkpoint), gradient accumulation
(``accum_grad_steps``), mid-epoch checkpoints (``ckpt_every_steps``),
``torch.profiler`` traces (``profile_dir``), plateau annealing of
adadelta's eps (``eps_decay``) with ``plateau_restore_best``, and
``early_stop_patience``.

With ``train.dp`` the trainer runs on every rank of a ``World``
(``parallel/mesh.py``): every rank loads every batch and runs every step
on its rows (``training/train_step.py``); every bucket's batch size must
divide the world size. The dev evaluation shards each batch over the
ranks where every dev bucket divides and otherwise decodes it whole on
every rank (a ``dp_eval_fallback`` line). Rank 0 alone writes
``metrics.jsonl`` and the checkpoints; every rank resumes from the same
file, and reads ``best.pt`` for ``plateau_restore_best`` only after a
barrier that follows rank 0's write. The stop decisions (``max_steps``,
early stopping) take the same values on every rank: the step count, and
the dev WER, which the evaluation gathers.
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
from gluon_e2e_asr_tpu_torch.training.checkpoint import (
    latest_checkpoint, restore_train_checkpoint, save_train_checkpoint)
from gluon_e2e_asr_tpu_torch.training.train_step import (
    Accumulator, batch_tensors, create_train_state, decay_opt_eps,
    make_grad_step, make_optimizer, make_train_step)
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
        # Gradient accumulation: micro-batch gradient passes, one update a
        # group.
        self.accum = max(1, int(config.train.accum_grad_steps))
        self.grad_step = self._acc = None
        if self.accum > 1:
            self.grad_step = make_grad_step(self.model, config,
                                            self.cmvn_stats, world)
            self._acc = Accumulator(self.model, self.optimizer, world)
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
        self.epoch0 = 0
        self.skip_batches = 0  # mid-epoch resume position
        self.best_wer = float("inf")
        # Epochs since the last best dev WER, for early stopping. Not
        # checkpointed, as in JAX: a resumed run restarts its patience.
        self._stale_epochs = 0

    def maybe_resume(self) -> None:
        """Restore the newest checkpoint of ``train.ckpt_dir``, if any: the
        parameters, optimizer state, step, generator state and cmvn stats,
        and from its meta the position (a mid-epoch checkpoint resumes its
        epoch after ``batches_done`` batches, an epoch-end one the next
        epoch) and ``best_wer``. A checkpoint of another vocabulary
        raises."""
        path = latest_checkpoint(os.path.join(self.workdir,
                                              self.config.train.ckpt_dir))
        if path is None:
            return
        ck = restore_train_checkpoint(path, self.state.opt_state, self.device)
        if ck.meta.get("vocab_hash") and (
                ck.meta["vocab_hash"] != self.tokenizer.fingerprint()):
            raise ValueError(
                f"resume vocab mismatch: checkpoint {path} was trained with "
                f"vocab {ck.meta['vocab_hash']}, this run built "
                f"{self.tokenizer.fingerprint()} (did data.tokenizer / the "
                "train manifest change?)")
        self.model.load_state_dict(ck.params)
        self.state.opt_state, self.state.step = ck.opt_state, ck.step
        self.state.generator.set_state(ck.generator)
        if ck.cmvn is not None:
            self.cmvn_stats = tuple(t.to(self.device) for t in ck.cmvn)
        check_replicated(list(self.model.parameters()), self.world)
        batches_done = int(ck.meta.get("batches_done", -1))
        epoch = int(ck.meta.get("epoch", -1))
        if batches_done >= 0:
            self.epoch0, self.skip_batches = epoch, batches_done
        else:
            self.epoch0, self.skip_batches = epoch + 1, 0
        self.best_wer = float(ck.meta.get("best_wer", float("inf")))
        self.logger.log({"event": "resume", "ckpt": path,
                         "epoch": self.epoch0,
                         "skip_batches": self.skip_batches})

    def _step(self, batch) -> Tuple[Optional[Dict[str, torch.Tensor]], bool]:
        """One batch: a whole step, or a micro-batch of an accumulation
        group. Returns (metrics, stepped); metrics is None until the
        group's update."""
        if self._acc is None:
            return self.train_step(self.state, batch), True
        self._acc.add(*self.grad_step(self.state, batch))
        if self._acc.micro < self.accum:
            return None, False
        return self._acc.apply(self.state), True

    def train(self) -> Dict[str, float]:
        tc = self.config.train
        step = self.state.step
        n_chips = self.world.size
        profiler = None
        final: Dict[str, float] = {}
        for epoch in range(self.epoch0, tc.num_epochs):
            t_epoch = time.perf_counter()
            utts_done, tokens_done = 0, 0
            real_samples, padded_samples = 0, 0
            window_t0, window_utts, window_tokens = time.perf_counter(), 0, 0
            stopped_at = -1
            skip = self.skip_batches if epoch == self.epoch0 else 0
            prefetch = self.loader.prefetch_epoch(
                epoch, skip=skip, depth=self.config.data.prefetch_depth)
            try:
                for batch_idx, b in prefetch:
                    if 0 < tc.max_steps <= step:
                        stopped_at = batch_idx
                        break
                    if (tc.profile_dir and profiler is None
                            and step == tc.profile_start_step):
                        profiler = self._start_profile()
                    metrics, stepped = self._step(batch_tensors(b))
                    step = self.state.step
                    if profiler is not None and step >= (
                            tc.profile_start_step + tc.profile_num_steps):
                        self._stop_profile(profiler)
                        profiler = None
                    utts_done += b.num_real
                    real_samples += int(b.audio_len.sum())
                    padded_samples += int(b.audio.shape[0] * b.audio.shape[1])
                    window_utts += b.num_real
                    window_tokens += int(b.label_len.sum())
                    tokens_done += int(b.label_len.sum())
                    if stepped and step % tc.log_every_steps == 0:
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
                    # Only on updates: a mid-epoch checkpoint never holds
                    # part of an accumulation group.
                    if (stepped and tc.ckpt_every_steps
                            and step % tc.ckpt_every_steps == 0):
                        self._checkpoint(epoch, None,
                                         batches_done=batch_idx + 1)
            finally:
                prefetch.close()
            train_time = time.perf_counter() - t_epoch
            if self._acc is not None and self._acc.micro and stopped_at < 0:
                # The epoch's last group is short: apply it (max_steps
                # stops only on group boundaries, so none is dropped).
                self._acc.apply(self.state)
                step = self.state.step
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
                self._stale_epochs = 0
            else:
                self._stale_epochs += 1
                self._plateau_anneal(epoch)
            self._checkpoint(epoch, is_best, dev_wer=dev["dev_wer"])
            final = rec
            if 0 < tc.max_steps <= step:
                break
            if (tc.early_stop_patience > 0
                    and self._stale_epochs >= tc.early_stop_patience):
                self.logger.log({"event": "early_stop", "epoch": epoch,
                                 "best_wer": self.best_wer,
                                 "patience": tc.early_stop_patience})
                break
        if profiler is not None:
            self._stop_profile(profiler)
        return final

    def _start_profile(self):
        """torch.profiler over the host and, on a card, the device, from
        ``train.profile_start_step`` for ``profile_num_steps`` updates."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> str:
        """Stop ``prof`` and write its Chrome trace under
        ``train.profile_dir`` (``trace_<first>-<last>_rank<r>.json``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        tc = self.config.train
        os.makedirs(tc.profile_dir, exist_ok=True)
        first = tc.profile_start_step
        path = os.path.join(
            tc.profile_dir, f"trace_{first}-{self.state.step}"
                            f"_rank{self.world.rank}.json")
        prof.export_chrome_trace(path)
        self.logger.log({"event": "profile", "trace": path,
                         "first_step": first, "last_step": self.state.step})
        return path

    def _plateau_anneal(self, epoch: int) -> None:
        """On an epoch with no new best dev WER (the JAX
        ``_plateau_anneal``): at the end of each window of
        ``eps_decay_patience`` such epochs, reload the parameters of
        ``best.pt`` (``plateau_restore_best``; the optimizer state is
        kept) and multiply the optimizer's eps by ``eps_decay`` (adadelta
        alone has one; otherwise an ``eps_decay_skipped`` line). The
        annealed eps lives in the optimizer state, so the epoch's
        checkpoint, written next, carries it into a resume."""
        tc = self.config.train
        if tc.eps_decay <= 0 and not tc.plateau_restore_best:
            return
        if self._stale_epochs % max(1, int(tc.eps_decay_patience)):
            return
        restored = False
        if tc.plateau_restore_best:
            best = os.path.join(self.workdir, tc.ckpt_dir, "best.pt")
            # Rank 0 wrote best.pt; the others read it after this barrier.
            self.world.barrier()
            if os.path.exists(best):
                ck = restore_train_checkpoint(best, device=self.device,
                                              params_only=True)
                self.model.load_state_dict(ck.params)
                restored = True
        if tc.eps_decay <= 0:
            if restored:
                self.logger.log({"event": "plateau_restore", "epoch": epoch})
            return
        new_opt, old_eps, new_eps = decay_opt_eps(self.state.opt_state,
                                                  tc.eps_decay)
        if old_eps is None:
            self.logger.log({
                "event": "eps_decay_skipped", "epoch": epoch,
                "restored_best": restored,
                "hint": "train.eps_decay set but the optimizer has no "
                        "injected eps (use train.optimizer: adadelta)"})
            return
        self.state.opt_state = new_opt
        self.logger.log({"event": "eps_decay", "epoch": epoch,
                         "eps_old": old_eps, "eps_new": new_eps,
                         "restored_best": restored})

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
            keep_policy=tc.keep_policy,
            generator=self.state.generator.get_state())
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
