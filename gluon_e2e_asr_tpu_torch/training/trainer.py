"""Datasets and vocab as the trainer builds them. Counterpart of
``gluon_e2e_asr_tpu/training/trainer.py::build_datasets``; the training
loop arrives with the training slice. The vocab comes from the JAX
package's jax-free ``data/tokenizer.py::build_tokenizer``, as there."""

from __future__ import annotations

from typing import List, Tuple

from gluon_e2e_asr_tpu.data.manifest import (
    Utterance,
    build_librispeech_manifest,
    build_synthetic_manifest,
    load_manifest,
)
from gluon_e2e_asr_tpu.data.tokenizer import build_tokenizer  # noqa: F401
from gluon_e2e_asr_tpu_torch.config import Config


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
