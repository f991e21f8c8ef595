"""Decode CLI: ``python -m gluon_e2e_asr_tpu_torch.decode --config <yaml>
--ckpt <path> [--device cuda]``.

Counterpart of ``gluon_e2e_asr_tpu/decode.py`` for greedy CTC decoding:
restore the port's checkpoint (with or without an attention decoder,
which greedy CTC decoding does not run) and its vocab, run the bucketed
dev batches through frontend -> encoder -> CTC head -> greedy collapse
-> detokenize, write per-utterance JSONL {utt_id, hyp, ref, score,
latency_s}, and print one ``decode_done`` JSON line with WER/CER and
p50 latency. Each bucket gets one untimed warm pass first. A JAX
checkpoint is converted with ``bridge.py`` and saved with
``training/checkpoint.py``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gluon_e2e_asr_tpu_torch.config import Config, apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.data.loader import DataLoader
from gluon_e2e_asr_tpu_torch.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr_tpu_torch.data.tokenizer import CharTokenizer, tokenizer_from_json
from gluon_e2e_asr_tpu_torch.decoding.greedy import ids_to_texts, make_greedy_decoder
from gluon_e2e_asr_tpu_torch.eval.metrics import cer, error_report, wer
from gluon_e2e_asr_tpu_torch.models.asr import build_model
from gluon_e2e_asr_tpu_torch.training.checkpoint import restore_checkpoint
from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets
from gluon_e2e_asr_tpu_torch.utils.logging import JsonlLogger, percentile


def make_eval_loader(config: Config, utts, tokenizer) -> DataLoader:
    """Bucketed, unshuffled batches of ``utts``, as the decoder sees them."""
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate,
        config.data.batch_size, config.data.max_label_len,
        config.frontend.hop_length, config.data.dynamic_batch,
    )
    sampler = BucketSampler(utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    return DataLoader(utts, sampler, tokenizer, config.data.sample_rate,
                      transfer_dtype=config.data.transfer_dtype)


def main(argv=None):
    p = argparse.ArgumentParser(description="E2E ASR decoding (PyTorch port)")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--output", type=str, default="")
    p.add_argument("--method", type=str, default="",
                   choices=["", "greedy", "beam", "ctc_beam"],
                   help="override decode.method")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="dotted config override (repeatable)")
    p.add_argument("--min-dur", type=float, default=0.0,
                   help="decode only dev utterances at least this many "
                        "seconds long")
    p.add_argument("--max-utts", type=int, default=0,
                   help="cap the dev set at the first N utterances after "
                        "filtering (0 = all)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    args = p.parse_args(argv)

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if args.method:
        config.decode.method = args.method
    if config.decode.method != "greedy":
        raise NotImplementedError(
            f"decode.method={config.decode.method!r}: the port decodes "
            "greedily only so far; beam search is next (ROADMAP.md)")
    if config.decode.dp:
        raise NotImplementedError(
            "decode.dp: data-parallel decoding is not ported yet "
            "(ROADMAP.md)")
    out_path = args.output or config.decode.output_path
    device = torch.device(args.device)
    if device.type == "cuda":
        # The frontend's DFT and mel products must run in true f32.
        torch.backends.cuda.matmul.allow_tf32 = False

    params, cmvn_stats, meta = restore_checkpoint(args.ckpt)
    tokenizer = (tokenizer_from_json(meta["vocab"]) if meta.get("vocab")
                 else CharTokenizer())
    _, dev_utts = build_datasets(config)
    if args.min_dur > 0:
        dev_utts = [u for u in dev_utts if u.duration >= args.min_dur]
    if args.max_utts > 0:
        dev_utts = dev_utts[: args.max_utts]
    if not dev_utts:
        raise SystemExit(
            f"--min-dur {args.min_dur} left no dev utterances to decode")
    loader = make_eval_loader(config, dev_utts, tokenizer)

    model = build_model(config, tokenizer.vocab_size,
                        use_decoder=any(k.startswith("decoder.") for k in params))
    model.load_state_dict(params)
    model.to(device).eval()
    decoder = make_greedy_decoder(model, config, cmvn_stats, device)

    # "w": each decode run owns its output file.
    logger = JsonlLogger(out_path, also_stdout=False, mode="w")
    refs, hyps, latencies = [], [], []
    by_id = {u.utt_id: u for u in dev_utts}
    warmed = set()
    num_batches = 0
    for b in loader.epoch(0):
        if b.bucket not in warmed:
            # One untimed pass per bucket shape, so p50 latency measures
            # steady-state time, not the kernels' first-use build or the
            # allocator's warm-up.
            ids, lens = decoder(b.audio, b.audio_len)
            ids.cpu(), lens.cpu()
            warmed.add(b.bucket)
        t0 = time.perf_counter()
        ids, lens = decoder(b.audio, b.audio_len)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        texts = ids_to_texts(ids.cpu().numpy(), lens.cpu().numpy(), tokenizer)
        dt = time.perf_counter() - t0
        num_batches += 1
        per_utt = dt / max(b.num_real, 1)
        for row, utt_id in enumerate(b.utt_ids):
            ref = by_id[utt_id].text
            refs.append(ref)
            hyps.append(texts[row])
            latencies.append(per_utt)
            logger.log({
                "utt_id": utt_id,
                "hyp": texts[row],
                "ref": ref,
                "score": 0.0,
                "latency_s": round(per_utt, 5),
            })
    result = {
        "event": "decode_done",
        "method": config.decode.method,
        "device": str(device),
        "num_utts": len(refs),
        "num_batches": num_batches,
        "warm_passes": len(warmed),
        "wer": round(wer(refs, hyps), 4),
        "cer": round(cer(refs, hyps), 4),
        # Batch wall time divided by real utterances in the batch: an
        # amortized per-utterance number, not a single-utterance latency.
        "latency_basis": "batch-amortized-per-utt",
        "p50_latency_s": round(percentile(latencies, 50), 5),
        "output": out_path,
    }
    rep = error_report(refs, hyps, unit="word")
    result["errors"] = {
        k: (round(v, 4) if isinstance(v, float) else v)
        for k, v in rep.items() if k != "unit"
    }
    print(json.dumps(result))
    logger.close()
    return result


if __name__ == "__main__":
    main()
