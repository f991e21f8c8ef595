"""Transcription CLI: decode audio files with a trained checkpoint, no
manifest or reference transcripts needed:

    python -m gluon_e2e_asr_tpu_torch.transcribe --ckpt <ckpt> \\
        [--config recipe.yaml] [--method greedy|beam|ctc_beam] \\
        [--output out.jsonl [--timestamps]] [--set KEY=VAL ...] \\
        [--device cuda|cpu] a.wav b.flac c.npy

Counterpart of ``gluon_e2e_asr_tpu/transcribe.py``. ``--ckpt`` is a port
checkpoint or a JAX trainer's (converted through ``bridge.py``). Files
are probed for their duration and bucketed like the eval loader, with a
catch-all bucket after the configured ones so that no file is skipped,
and go through the decoders of ``decode.py``. Prints ``utt_id<TAB>hyp``
per file in file order; ``--output`` also writes decode-style JSONL
records, and ``--timestamps`` adds per-token {token, start_s, end_s}
spans to them by CTC-force-aligning each hypothesis
(``ops/ctc.py::ctc_viterbi_align``; encoder frame f spans f*R*hop/sr ..
(f+1)*R*hop/sr, R = ``config.encoder_time_reduction``; the CTC head must
have been trained, ``loss.mtl_alpha > 0``). At B=1 the beams take the
serving defaults, as in ``decode.py``. ``.flac`` files decode through the
port's native decoder (``utils/native.py``); a malformed or missing file
raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import (
    Config, apply_overrides, encoder_time_reduction, load_config)
from gluon_e2e_asr_tpu_torch.data.loader import DataLoader
from gluon_e2e_asr_tpu_torch.data.manifest import Utterance, _probe_duration
from gluon_e2e_asr_tpu_torch.data.sampler import (
    BucketSampler, BucketSpec, make_bucket_specs)
from gluon_e2e_asr_tpu_torch.decode import restore_model
from gluon_e2e_asr_tpu_torch.decoding.beam import make_beam_decoder
from gluon_e2e_asr_tpu_torch.decoding.greedy import ids_to_texts, make_greedy_decoder
from gluon_e2e_asr_tpu_torch.decoding.serving import apply_b1_serving_defaults
from gluon_e2e_asr_tpu_torch.frontend.features import frontend_apply
from gluon_e2e_asr_tpu_torch.ops.ctc import ctc_viterbi_align, spans_from_states
from gluon_e2e_asr_tpu_torch.utils.logging import JsonlLogger


def build_file_utts(paths, sample_rate):
    """Probe each audio file and wrap it as a manifest Utterance."""
    utts = []
    for i, p in enumerate(paths):
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        dur = _probe_duration(p, sample_rate)
        if dur <= 0:
            raise ValueError(
                f"{p}: could not determine duration (supported: 16 kHz "
                ".wav/.flac, .npy float32)")
        utts.append(Utterance(
            utt_id=f"{i:04d}_{os.path.basename(p)}",
            text="", duration=round(dur, 4), audio_path=p))
    return utts


def specs_covering(config, max_dur):
    """The eval bucket specs and, for files longer than the largest
    bound, a catch-all bucket appended after them (folding it into the
    bounds would scale every bucket's batch size under
    ``data.dynamic_batch``). Its batch size scales from the largest
    configured bound, floored at 1."""
    bounds = list(config.data.bucket_bounds_sec)
    specs = make_bucket_specs(
        bounds, config.data.sample_rate, config.data.batch_size,
        config.data.max_label_len, config.frontend.hop_length,
        config.data.dynamic_batch,
    )
    if max_dur > bounds[-1]:
        b = float(np.ceil(max_dur * 2) / 2)  # round up to 0.5 s
        hop = config.frontend.hop_length
        n = int(round(b * config.data.sample_rate))
        n = ((n + hop - 1) // hop) * hop
        bs = config.data.batch_size
        if config.data.dynamic_batch:
            bs = max(1, int(bs * bounds[-1] / b))
        specs.append(BucketSpec(
            max_samples=n, max_labels=config.data.max_label_len,
            batch_size=bs))
    return specs


def make_align_fn(model, config: Config, cmvn_stats, device: torch.device):
    """fn(audio, audio_len, labels, label_len) -> (states [B,T'] int32,
    score [B]) on the host: frontend -> encoder -> the CTC head's
    log-softmax -> ``ctc_viterbi_align``, on ``device``."""
    if cmvn_stats is not None:
        cmvn_stats = tuple(torch.as_tensor(s, dtype=torch.float32,
                                           device=device) for s in cmvn_stats)

    @torch.inference_mode()
    def align_fn(audio, audio_len, labels, label_len):
        to = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
        feats, feat_len = frontend_apply(config.frontend, to(audio),
                                         to(audio_len), cmvn_stats=cmvn_stats)
        _, enc_len, ctc_logits = model.encode(feats, feat_len)
        logp = torch.log_softmax(ctc_logits.float(), dim=-1)
        states, score = ctc_viterbi_align(logp, enc_len, to(labels),
                                          to(label_len))
        return states.cpu().numpy(), score.cpu().numpy()

    return align_fn


def sec_per_frame(config: Config) -> float:
    """Seconds an encoder frame spans."""
    return (encoder_time_reduction(config.model) * config.frontend.hop_length
            / config.data.sample_rate)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Transcribe audio files with a trained checkpoint "
                    "(PyTorch port)")
    p.add_argument("audio", nargs="+", help="16 kHz .wav/.flac/.npy files")
    p.add_argument("--ckpt", type=str, required=True,
                   help="a port checkpoint or a JAX trainer's")
    p.add_argument("--config", type=str, default="",
                   help="the training recipe yaml (model/frontend fields "
                        "must match the checkpoint)")
    p.add_argument("--method", type=str, default="",
                   choices=["", "greedy", "beam", "ctc_beam"],
                   help="override decode.method")
    p.add_argument("--output", type=str, default="",
                   help="also write decode-style JSONL records here")
    p.add_argument("--timestamps", action="store_true",
                   help="add per-token {token, start_s, end_s} spans to "
                        "the --output JSONL records by CTC-force-aligning "
                        "each hypothesis (needs a CTC-trained head)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    args = p.parse_args(argv)
    if args.timestamps and not args.output:
        p.error("--timestamps writes token spans into the JSONL records; "
                "pass --output as well")

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if args.method:
        config.decode.method = args.method
    # Interactive serving at B=1 (explicit --set values win).
    apply_b1_serving_defaults(config, args.set)
    device = torch.device(args.device)
    if device.type == "cuda":
        # The frontend's DFT and mel products must run in true f32.
        torch.backends.cuda.matmul.allow_tf32 = False

    model, cmvn_stats, tokenizer = restore_model(config, args.ckpt, device)
    utts = build_file_utts(args.audio, config.data.sample_rate)
    specs = specs_covering(config, max(u.duration for u in utts))
    sampler = BucketSampler(utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    if sampler.skipped:
        # Only a label overflow could skip now, and the texts are empty.
        bad = [utts[i].audio_path for i in sampler.skipped]
        raise ValueError(f"unbucketable inputs: {bad}")
    loader = DataLoader(utts, sampler, tokenizer, config.data.sample_rate,
                        transfer_dtype=config.data.transfer_dtype)

    is_beam = config.decode.method in ("beam", "ctc_beam")
    if is_beam:
        decoder = make_beam_decoder(model, config, tokenizer, cmvn_stats,
                                    device=device)
    else:
        decoder = make_greedy_decoder(model, config, cmvn_stats, device)
    align_fn = make_align_fn(model, config, cmvn_stats, device) \
        if args.timestamps else None
    spf = sec_per_frame(config)

    def run(b):
        if is_beam:
            texts, scores = decoder(b.audio, b.audio_len)
            return texts, [float(s) for s in scores]
        ids, lens = decoder(b.audio, b.audio_len)
        return (ids_to_texts(ids.cpu().numpy(), lens.cpu().numpy(), tokenizer),
                [0.0] * len(b.utt_ids))

    logger = JsonlLogger(args.output, also_stdout=False, mode="w") \
        if args.output else None
    results = {}
    warmed = set()
    for b in loader.epoch(0):
        if b.bucket not in warmed:
            # One untimed pass per bucket shape, as in decode.py.
            run(b)
            warmed.add(b.bucket)
        t0 = time.perf_counter()
        texts, scores = run(b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        per_utt = (time.perf_counter() - t0) / max(b.num_real, 1)
        spans = [None] * len(texts)
        if align_fn is not None:
            # Force-align each hypothesis: its ids in the batch's label
            # shape (clipped to the bucket's label budget), Viterbi over
            # the CTC lattice.
            L = b.labels.shape[1]
            labels = np.zeros_like(b.labels)
            label_len = np.zeros_like(b.label_len)
            for row, t in enumerate(texts):
                ids_row = tokenizer.encode(t)[:L]
                labels[row, :len(ids_row)] = ids_row
                label_len[row] = len(ids_row)
            states, _ = align_fn(b.audio, b.audio_len, labels, label_len)
            for row in range(len(texts)):
                toks = [tokenizer.decode([int(i)])
                        for i in labels[row][: label_len[row]]]
                spans[row] = spans_from_states(states[row], toks, spf)
        for row, utt_id in enumerate(b.utt_ids):
            results[utt_id] = texts[row]
            if logger is not None:
                rec = {
                    "utt_id": utt_id,
                    "hyp": texts[row],
                    "score": float(scores[row]),
                    "latency_s": round(per_utt, 5),
                    "latency_basis": "batch-amortized-per-utt",
                }
                if spans[row] is not None:
                    rec["tokens"] = spans[row]
                logger.log(rec)
    # File order, whatever the buckets (the ids' zero-padded index would
    # not sort past 9999 files).
    for u in utts:
        if u.utt_id in results:
            print(f"{u.utt_id}\t{results[u.utt_id]}")
    if logger is not None:
        logger.close()
    return results


if __name__ == "__main__":
    main()
