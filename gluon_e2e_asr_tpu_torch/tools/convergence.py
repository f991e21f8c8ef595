"""Train a config to convergence, decode its best checkpoint over the dev
set and hold the records to a reference decode of the same utterances.

    python -m gluon_e2e_asr_tpu_torch.tools.convergence --config <yaml> \
        --reference <records.jsonl> --workdir <dir> [--set key=value] \
        [--device cuda|cpu]

Four steps:

1. the refs of the config's dev set (``build_datasets``) against the
   reference records' ``ref``, utterance for utterance: a mismatch raises,
   since the paired comparison would be void;
2. the train CLI on the config with the given overrides, every epoch, the
   dev evaluation at each epoch's end picking ``best.pt``;
3. the decode CLI on ``best.pt`` with the config's own decode block over
   the whole dev set; the records (``utt_id``, ``ref``, ``hyp``,
   ``score``) to ``<workdir>/best_dev.jsonl``;
4. ``compare``: WER and CER with their 95% bootstrap intervals, and the
   paired difference WER(records) - WER(reference) with its 95% interval
   and p(diff >= 0), through ``tools/wer_ci.py`` (10,000 resamples, seed
   0, paired by ``utt_id``).

Prints one ``convergence_done`` JSON line. A paired interval that holds
0 is a tie: the two runs differ in their seeds' draws (initialisation,
SpecAugment, scheduled sampling), and the interval covers the decode's
variance over utterances, not the variance between training seeds.

Two helpers keep a run's evidence in the same form whichever package
trained it (the JAX package's train and decode CLIs write the same
``metrics.jsonl`` and record lines):

    python -m gluon_e2e_asr_tpu_torch.tools.convergence epochs \
        <workdir>/metrics.jsonl <out_epochs.jsonl>
    python -m gluon_e2e_asr_tpu_torch.tools.convergence records \
        <decode --output file> <out.jsonl>

``epochs`` keeps each ``epoch`` line with ``loss_logged``, the mean loss
of that epoch's ``train`` lines (logged every ``train.log_every`` steps);
``records`` keeps RECORD_KEYS of each record, sorted by ``utt_id``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

RECORD_KEYS = ("utt_id", "ref", "hyp", "score")
ITERS, SEED = 10000, 0  # the bootstrap's resamples and generator seed


def read_records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def write_records(path: str, records) -> None:
    """Records sorted by ``utt_id``, each with RECORD_KEYS alone."""
    with open(path, "w") as f:
        for r in sorted(records, key=lambda r: r["utt_id"]):
            f.write(json.dumps({k: r[k] for k in RECORD_KEYS if k in r}) + "\n")


def epoch_records(lines) -> list:
    """The ``epoch`` lines of a run's metrics, each with ``loss_logged``:
    the mean ``loss`` of the ``train`` lines logged in that epoch."""
    out, losses = [], []
    for r in lines:
        if r.get("event") == "train":
            losses.append(float(r["loss"]))
        elif r.get("event") == "epoch":
            out.append(dict(r, loss_logged=float(np.mean(losses))
                            if losses else None))
            losses = []
    return out


def write_lines(path: str, rows) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def dev_refs(config) -> dict:
    """utt_id -> the reference text of the config's dev set."""
    from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets

    return {u.utt_id: u.text for u in build_datasets(config)[1]}


def refs_match(refs: dict, records) -> int:
    """How many of ``records`` carry the ref that ``refs`` holds for their
    ``utt_id``; all of them, and every utterance of ``refs``, must."""
    return sum(refs.get(r["utt_id"]) == r["ref"] for r in records)


def _intervals(counts, iters: int, seed: int) -> dict:
    from gluon_e2e_asr_tpu_torch.tools.wer_ci import bootstrap_ci

    w, lw, hw, ce, lc, hc = bootstrap_ci(counts, iters, seed)
    return {"utts": len(counts), "wer": w, "wer_ci95": [lw, hw], "cer": ce,
            "cer_ci95": [lc, hc], "bootstrap_iters": iters,
            "bootstrap_seed": seed}


def intervals(path: str, iters: int = ITERS, seed: int = SEED) -> dict:
    """WER/CER of the records at ``path`` with 95% bootstrap intervals
    (``tools/wer_ci.py``), for a record with no reference to pair with."""
    from gluon_e2e_asr_tpu_torch.tools.wer_ci import per_utt_counts

    counts = per_utt_counts(path, keyed=True)
    return _intervals(np.asarray([counts[k] for k in sorted(counts)],
                                 np.float64), iters, seed)


def compare(path: str, reference: str, iters: int = ITERS,
            seed: int = SEED) -> dict:
    """WER/CER of the records at ``path`` with 95% bootstrap intervals, and
    the paired difference against ``reference``'s records, paired by
    ``utt_id`` (``tools/wer_ci.py``'s ``--compare``)."""
    from gluon_e2e_asr_tpu_torch.tools.wer_ci import (
        bootstrap_ci, paired_diff_ci, per_utt_counts)

    ca = per_utt_counts(path, keyed=True)
    cb = per_utt_counts(reference, keyed=True)
    shared = sorted(set(ca) & set(cb))
    if not len(shared) == len(ca) == len(cb):
        raise ValueError(f"{path} and {reference} decode different "
                         f"utterance sets ({len(ca)}, {len(cb)}, "
                         f"{len(shared)} shared)")
    a = np.asarray([ca[k] for k in shared], np.float64)
    b = np.asarray([cb[k] for k in shared], np.float64)
    rw, rlw, rhw = bootstrap_ci(b, iters, seed)[:3]
    d, lo, hi, p_ge = paired_diff_ci(a, b, iters, seed)
    return {**_intervals(a, iters, seed), "reference_wer": rw,
            "reference_wer_ci95": [rlw, rhw], "wer_diff": d,
            "wer_diff_ci95": [lo, hi], "p_diff_ge_0": p_ge,
            "tie": bool(lo <= 0.0 <= hi)}


def train(config_path: str, workdir: str, overrides=(), device="cuda"):
    """The train CLI, every epoch of the config. Returns the trainer and
    its metrics lines."""
    from gluon_e2e_asr_tpu_torch import train as train_cli

    sets = [a for o in overrides for a in ("--set", o)]
    trainer = train_cli.main(["--config", config_path, *sets, "--workdir",
                              workdir, "--device", device])
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return trainer, [json.loads(line) for line in f]


def best_checkpoint(trainer) -> tuple:
    """(path of ``best.pt``, the epoch it holds) of a finished run."""
    tc = trainer.config.train
    path = os.path.join(trainer.workdir, tc.ckpt_dir, "best.pt")
    with open(path + ".json") as f:
        return path, int(json.load(f)["epoch"])


def decode_best(config_path: str, ckpt: str, out: str, overrides=(),
                device="cuda", method: str = "") -> dict:
    """The decode CLI on ``ckpt`` by the config's own decode block (or by
    ``method``) over the whole dev set; the records to ``out``
    (RECORD_KEYS). Returns its ``decode_done`` summary."""
    from gluon_e2e_asr_tpu_torch import decode

    raw = out + ".raw"
    sets = [a for o in overrides for a in ("--set", o)]
    sets += ["--method", method] if method else []
    result = decode.main(["--config", config_path, *sets, "--ckpt", ckpt,
                          "--output", raw, "--device", device])
    write_records(out, read_records(raw))
    os.remove(raw)
    return result


def main(argv=None) -> dict:
    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] in (["epochs"], ["records"]):
        what, src, out = argv
        rows = read_records(src)
        if what == "epochs":
            write_lines(out, epoch_records(rows))
        else:
            write_records(out, rows)
        return {"event": what, "from": src, "to": out}
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--reference", required=True,
                   help="per-utterance records of the same dev set")
    p.add_argument("--workdir", required=True)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    config = load_config(args.config)
    apply_overrides(config, args.set)
    refs = dev_refs(config)
    ref_records = read_records(args.reference)
    n_match = refs_match(refs, ref_records)
    if not n_match == len(refs) == len(ref_records):
        raise ValueError(f"{args.reference}: {n_match} of its "
                         f"{len(ref_records)} refs equal the config's dev set "
                         f"({len(refs)} utterances): the comparison is void")
    trainer, _ = train(args.config, args.workdir, args.set, args.device)
    ckpt, best_epoch = best_checkpoint(trainer)
    out = os.path.join(args.workdir, "best_dev.jsonl")
    decode_best(args.config, ckpt, out, args.set, args.device)
    summary = {"event": "convergence_done", "config": args.config,
               "best_epoch": best_epoch, "records": out,
               **compare(out, args.reference)}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    try:
        main()
    finally:
        import torch

        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
