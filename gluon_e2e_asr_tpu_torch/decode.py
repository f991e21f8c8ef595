"""Decode CLI: ``python -m gluon_e2e_asr_tpu_torch.decode --config <yaml>
--ckpt <path> [--method greedy|beam|ctc_beam] [--device cuda]``.

Counterpart of ``gluon_e2e_asr_tpu/decode.py``: restore the port's
checkpoint (with or without an attention decoder) and its vocab, run the
bucketed dev batches through frontend -> encoder -> greedy CTC collapse
(``greedy``) or the batched joint CTC/attention beam search (``beam``;
``ctc_beam`` without the decoder) -> detokenize, write per-utterance
JSONL {utt_id, hyp, ref, score, latency_s} (and ``nbest`` with
``decode.nbest > 1``), and print one ``decode_done`` JSON line with
WER/CER, p50 latency and, for the beams, the output steps run. At B=1 the
beams take the serving defaults of ``decoding/serving.py``. The beams fuse
an external LM with ``--set decode.lm_weight=W --set decode.lm_ckpt=<a
train_lm.py checkpoint of the port or the JAX package>``; with
``decode.nbest > 1`` the records are what ``tools/rescore_nbest.py``
reads. ``--ckpt`` is a port checkpoint or a JAX trainer's (converted
through ``bridge.py``). Each bucket
gets one untimed warm pass first. A JAX checkpoint is converted with
``bridge.py`` and saved with ``training/checkpoint.py``.

With ``decode.dp`` every rank of the default process group
(``parallel/mesh.py``; ``torchrun --nproc_per_node=N -m
gluon_e2e_asr_tpu_torch.decode ...``, or one process without torchrun)
decodes its block of each batch's rows; every bucket's batch size must
divide the world size. Rank 0 writes the records and prints the line.
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
from gluon_e2e_asr_tpu_torch.decoding.beam import NEG_INF as BEAM_NEG_INF
from gluon_e2e_asr_tpu_torch.decoding.beam import make_beam_decoder
from gluon_e2e_asr_tpu_torch.decoding.greedy import ids_to_texts, make_greedy_decoder
from gluon_e2e_asr_tpu_torch.decoding.serving import apply_b1_serving_defaults
from gluon_e2e_asr_tpu_torch.eval.metrics import cer, edit_distance, error_report, wer
from gluon_e2e_asr_tpu_torch.models.asr import build_model
from gluon_e2e_asr_tpu_torch.parallel.mesh import SINGLE, init_data_parallel
from gluon_e2e_asr_tpu_torch.training.checkpoint import restore_params
from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets, check_divisible
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


def restore_model(config: Config, path: str, device: torch.device):
    """(model on ``device`` in eval mode, cmvn_stats, tokenizer) of a port
    or JAX trainer checkpoint (``restore_params``); the tokenizer from
    its sidecar's vocab (the default char vocab without one), the decoder
    built where the checkpoint has one."""
    params, cmvn_stats, meta = restore_params(path)
    tokenizer = (tokenizer_from_json(meta["vocab"]) if meta.get("vocab")
                 else CharTokenizer())
    model = build_model(config, tokenizer.vocab_size,
                        sos_id=tokenizer.sos_id, eos_id=tokenizer.eos_id,
                        use_decoder=any(k.startswith("decoder.") for k in params))
    model.load_state_dict(params)
    return model.to(device).eval(), cmvn_stats, tokenizer


def filled_nbest(nbest_row):
    """Drop unfilled n-best slots: the beam pads them with its NEG_INF
    sentinel (-1e30), which is finite."""
    return [(t, s) for t, s in nbest_row if s > BEAM_NEG_INF / 2]


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
    out_path = args.output or config.decode.output_path
    device = torch.device(args.device)
    world = SINGLE
    if config.decode.dp:
        world = init_data_parallel(device.type)
        if device.type == "cuda":
            device = torch.device("cuda", world.local_rank)
    if device.type == "cuda":
        # The frontend's DFT and mel products must run in true f32.
        torch.backends.cuda.matmul.allow_tf32 = False

    model, cmvn_stats, tokenizer = restore_model(config, args.ckpt, device)
    _, dev_utts = build_datasets(config)
    if args.min_dur > 0:
        dev_utts = [u for u in dev_utts if u.duration >= args.min_dur]
    if args.max_utts > 0:
        dev_utts = dev_utts[: args.max_utts]
    if not dev_utts:
        raise SystemExit(
            f"--min-dur {args.min_dur} left no dev utterances to decode")
    loader = make_eval_loader(config, dev_utts, tokenizer)
    check_divisible(loader.sampler.specs, world, "decode.dp")
    # Interactive serving at B=1: partial CTC scoring and end detection
    # (explicit --set values win; batched decoding is unchanged).
    apply_b1_serving_defaults(config, args.set)

    is_beam = config.decode.method in ("beam", "ctc_beam")
    if is_beam:
        decoder = make_beam_decoder(model, config, tokenizer, cmvn_stats,
                                    mesh=world, device=device)
    else:
        decoder = make_greedy_decoder(model, config, cmvn_stats, device,
                                      mesh=world)

    def run(b):
        """(texts, scores, n-best lists or None) of one batch, on the host."""
        if is_beam and config.decode.nbest > 1:
            nbest = decoder.nbest(b.audio, b.audio_len)
            return [nb[0][0] for nb in nbest], [nb[0][1] for nb in nbest], nbest
        if is_beam:
            texts, scores = decoder(b.audio, b.audio_len)
            return texts, [float(s) for s in scores], None
        ids, lens = decoder(b.audio, b.audio_len)
        return (ids_to_texts(ids.cpu().numpy(), lens.cpu().numpy(), tokenizer),
                [0.0] * len(b.utt_ids), None)

    # "w": each decode run owns its output file (rank 0's).
    logger = JsonlLogger(out_path if world.is_main else None,
                         also_stdout=False, mode="w")
    refs, hyps, latencies = [], [], []
    beam_steps = []  # output steps run per batch (the beams)
    oracle_hyps = []  # per utterance, the n-best entry with the fewest word errors
    by_id = {u.utt_id: u for u in dev_utts}
    warmed = set()
    num_batches = 0
    for b in loader.epoch(0):
        if b.bucket not in warmed:
            # One untimed pass per bucket shape, so p50 latency measures
            # steady-state time, not the kernels' first-use build or the
            # allocator's warm-up.
            run(b)
            warmed.add(b.bucket)
        t0 = time.perf_counter()
        texts, scores, nbest_lists = run(b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        num_batches += 1
        if is_beam:
            beam_steps.append(int(decoder.last_steps))
        per_utt = dt / max(b.num_real, 1)
        for row, utt_id in enumerate(b.utt_ids):
            ref = by_id[utt_id].text
            refs.append(ref)
            hyps.append(texts[row])
            latencies.append(per_utt)
            rec = {
                "utt_id": utt_id,
                "hyp": texts[row],
                "ref": ref,
                "score": float(scores[row]),
                "latency_s": round(per_utt, 5),
            }
            if nbest_lists is not None:
                filled = filled_nbest(nbest_lists[row])
                rec["nbest"] = [{"hyp": t, "score": round(s, 4)}
                                for t, s in filled]
                rw = ref.split()
                oracle_hyps.append(min(
                    [t for t, _ in filled] or [""],
                    key=lambda t: edit_distance(rw, t.split())))
            logger.log(rec)
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
    if beam_steps:
        result["beam_steps_total"] = int(sum(beam_steps))
        result["beam_steps_max"] = int(max(beam_steps))
    rep = error_report(refs, hyps, unit="word")
    result["errors"] = {
        k: (round(v, 4) if isinstance(v, float) else v)
        for k, v in rep.items() if k != "unit"
    }
    if oracle_hyps:
        # The best WER a per-utterance pick from the n-best list reaches.
        result["oracle_wer"] = round(wer(refs, oracle_hyps), 4)
    if world.is_main:
        print(json.dumps(result))
    logger.close()
    return result


if __name__ == "__main__":
    try:
        main()
    finally:
        # The process group decode.dp joined, if any.
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
