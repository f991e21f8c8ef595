"""Offline n-best LM rescoring: re-rank each utterance's beam n-best
list with the external LM and report the re-ranked WER.

    python -m gluon_e2e_asr_tpu_torch.tools.rescore_nbest records.jsonl \
        --lm <lm ckpt> [--weight 0.3] [--lm-length-norm] \
        [--output rescored.jsonl] [--device cuda|cpu]

Counterpart of the JAX package's ``tools/rescore_nbest.py``.
``records.jsonl`` comes from the decode CLI with ``decode.nbest > 1``
(each record carries ``nbest: [{hyp, score}, ...]``); ``--lm`` is a
``train_lm.py`` checkpoint of the port or of the JAX package. The
re-ranked score is ``score + weight * log p_lm(hyp, eos)`` (divided by
the token count + 1 with ``--lm-length-norm``, for decodes run with
``decode.length_norm``). Every candidate goes through one batched LM
pass (``models/lm.py::lm_logprob_batch``). Prints one JSON summary line
{event: rescore_done, num_utts, lm_weight, baseline_wer, rescored_wer,
oracle_wer, output}; ``--output`` writes the re-ranked records.
"""

from __future__ import annotations

import argparse
import json

import torch

from gluon_e2e_asr_tpu_torch.data.tokenizer import CharTokenizer, tokenizer_from_json
from gluon_e2e_asr_tpu_torch.eval.metrics import edit_distance, wer
from gluon_e2e_asr_tpu_torch.models.lm import lm_logprob_batch, load_lm


def main(argv=None):
    p = argparse.ArgumentParser(description="n-best LM rescoring "
                                "(PyTorch port)")
    p.add_argument("records", help="decode JSONL with nbest lists")
    p.add_argument("--lm", required=True, help="train_lm.py checkpoint")
    p.add_argument("--weight", type=float, default=0.3)
    p.add_argument("--lm-length-norm", action="store_true",
                   help="divide each candidate's LM log-prob by its "
                        "token count (+1 for eos). Use when the decode "
                        "ran with decode.length_norm=true, so both "
                        "terms of the re-ranked score are per-token "
                        "quantities.")
    p.add_argument("--output", default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the LM: cuda or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the LM's f32 products

    model, meta = load_lm(args.lm, device)
    tokenizer = (tokenizer_from_json(meta["vocab"])
                 if meta.get("vocab") else CharTokenizer())

    records = []
    with open(args.records) as f:
        for line in f:
            rec = json.loads(line)
            if not rec.get("nbest"):
                raise SystemExit(
                    "records carry no nbest lists — decode with "
                    "--set decode.nbest=N (N > 1)")
            records.append(rec)

    flat = [tokenizer.encode(c["hyp"])
            for rec in records for c in rec["nbest"]]
    lps = lm_logprob_batch(model, flat, tokenizer.eos_id, tokenizer.sos_id)

    refs, base_hyps, new_hyps, oracle_hyps = [], [], [], []
    out_records = []
    pos = 0
    for rec in records:
        nbest = rec["nbest"]
        refs.append(rec["ref"])
        base_hyps.append(nbest[0]["hyp"])
        rescored = []
        for cand in nbest:
            lp = float(lps[pos])
            pos += 1
            lm_term = lp
            if args.lm_length_norm:
                lm_term = lp / (len(tokenizer.encode(cand["hyp"])) + 1)
            rescored.append(
                {"hyp": cand["hyp"],
                 "score": cand["score"] + args.weight * lm_term,
                 "am_score": cand["score"],
                 "lm_logprob": round(lp, 4)})
        rescored.sort(key=lambda c: -c["score"])
        new_hyps.append(rescored[0]["hyp"])
        rw = rec["ref"].split()
        oracle_hyps.append(min(
            (c["hyp"] for c in rescored),
            key=lambda t: edit_distance(rw, t.split())))
        out_records.append(dict(rec, hyp=rescored[0]["hyp"], nbest=rescored))

    if args.output:
        with open(args.output, "w") as f:
            for rec in out_records:
                f.write(json.dumps(rec) + "\n")
    summary = {
        "event": "rescore_done",
        "num_utts": len(refs),
        "lm_weight": args.weight,
        "baseline_wer": round(wer(refs, base_hyps), 4),
        "rescored_wer": round(wer(refs, new_hyps), 4),
        "oracle_wer": round(wer(refs, oracle_hyps), 4),
        "output": args.output,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
