"""CTC forced alignment CLI: token timestamps for reference transcripts.

    python -m gluon_e2e_asr_tpu_torch.tools.align --config <yaml> \
        --ckpt <ckpt> [--output align.jsonl] [--ctm align.ctm] \
        [--num N] [--set KEY=VAL ...] [--device cuda|cpu]

Counterpart of the JAX package's ``tools/align.py``: aligns each dev
utterance's reference text to its audio with the checkpoint's CTC head
(``ops/ctc.py::ctc_viterbi_align``, Viterbi over the blank-interleaved
lattice, on the device) and writes one JSONL record per utterance,
{utt_id, text, score, tokens: [{token, start_s, end_s}, ...]} (with
``truncated: true`` where the bucket's label budget cut the transcript),
and with ``--ctm`` sclite CTM lines. Encoder frame f spans
f*R*hop/sr .. (f+1)*R*hop/sr, R = ``config.encoder_time_reduction``.
``--ckpt`` is a port checkpoint or a JAX trainer's. The CTC head must
have been trained (``loss.mtl_alpha > 0``); the CLI warns otherwise.
Prints one ``align_done`` JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gluon_e2e_asr_tpu_torch.config import Config, apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.data.loader import DataLoader
from gluon_e2e_asr_tpu_torch.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr_tpu_torch.ops.ctc import spans_from_states
from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets
from gluon_e2e_asr_tpu_torch.decode import restore_model
from gluon_e2e_asr_tpu_torch.transcribe import make_align_fn, sec_per_frame
from gluon_e2e_asr_tpu_torch.utils.logging import JsonlLogger


def write_ctm(fh, utt_id, spans):
    """sclite CTM lines ``utt channel start dur token`` (channel 1;
    whitespace tokens as <sp>; unaligned tokens skipped)."""
    for s in spans:
        if s["start_s"] is None:
            continue
        tok = s["token"] if s["token"].strip() else "<sp>"
        fh.write(f"{utt_id} 1 {s['start_s']:.4f} "
                 f"{s['end_s'] - s['start_s']:.4f} {tok}\n")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="CTC forced alignment of reference transcripts "
                    "(PyTorch port)")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--output", type=str, default="align.jsonl")
    p.add_argument("--num", type=int, default=0,
                   help="align at most N utterances (0 = all)")
    p.add_argument("--ctm", type=str, default="",
                   help="also write sclite CTM lines "
                        "(utt_id channel start_s dur_s token)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    args = p.parse_args(argv)

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if config.loss.mtl_alpha <= 0:
        print("warning: loss.mtl_alpha == 0 — the checkpoint has no "
              "trained CTC head; alignments will be meaningless",
              file=sys.stderr)
    device = torch.device(args.device)
    if device.type == "cuda":
        # The frontend's DFT and mel products must run in true f32.
        torch.backends.cuda.matmul.allow_tf32 = False

    model, cmvn_stats, tokenizer = restore_model(config, args.ckpt, device)
    _, dev_utts = build_datasets(config)
    if args.num > 0:
        dev_utts = dev_utts[: args.num]
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate,
        config.data.batch_size, config.data.max_label_len,
        config.frontend.hop_length, config.data.dynamic_batch,
    )
    sampler = BucketSampler(dev_utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    if sampler.skipped:
        print(f"warning: {len(sampler.skipped)} utterance(s) exceed every "
              "bucket bound (duration or label budget) and are NOT "
              "aligned — raise data.bucket_bounds_sec / "
              "data.max_label_len", file=sys.stderr)
    loader = DataLoader(dev_utts, sampler, tokenizer,
                        config.data.sample_rate,
                        transfer_dtype=config.data.transfer_dtype)
    align_fn = make_align_fn(model, config, cmvn_stats, device)
    spf = sec_per_frame(config)

    by_id = {u.utt_id: u for u in dev_utts}
    logger = JsonlLogger(args.output, also_stdout=False, mode="w")
    ctm = open(args.ctm, "w") if args.ctm else None
    n = n_trunc = 0
    for b in loader.epoch(0):
        states, score = align_fn(b.audio, b.audio_len, b.labels, b.label_len)
        for row, utt_id in enumerate(b.utt_ids):
            text = by_id[utt_id].text
            toks = [tokenizer.decode([int(i)])
                    for i in b.labels[row][: b.label_len[row]]]
            spans = spans_from_states(states[row], toks, spf)
            rec = {"utt_id": utt_id, "text": text,
                   "score": float(score[row]), "tokens": spans}
            # The loader clips labels to the bucket's label budget: say so
            # rather than lose the tail tokens silently.
            if int(b.label_len[row]) < len(tokenizer.encode(text)):
                rec["truncated"] = True
                n_trunc += 1
            logger.log(rec)
            if ctm is not None:
                write_ctm(ctm, utt_id, spans)
            n += 1
    logger.close()
    if ctm is not None:
        ctm.close()
    summary = {"event": "align_done", "num_utts": n,
               "skipped": len(sampler.skipped),
               "sec_per_frame": spf,
               "output": args.output}
    if n_trunc:
        summary["truncated"] = n_trunc
        print(f"warning: {n_trunc} transcript(s) exceeded the bucket "
              "label budget; their tail tokens are missing from the "
              "alignment (records carry truncated: true)",
              file=sys.stderr)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
