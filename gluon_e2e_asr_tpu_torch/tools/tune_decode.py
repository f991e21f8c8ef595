"""Grid-search the beam's knobs on a tune/holdout split of the dev set.

    python -m gluon_e2e_asr_tpu_torch.tools.tune_decode \
        --config configs/milestone5_beam.yaml --ckpt <ckpt> \
        --grid ctc_weight=0.0,0.1,0.3,0.5 --grid penalty=0.0,0.3 \
        [--holdout-frac 0.5] [--output tune.jsonl] [--set KEY=VAL ...] \
        [--device cuda|cpu]

Counterpart of the root ``tools/tune_decode.py``. Any ``decode.<knob>``
(``ctc_weight``, ``penalty``, ``beam_size``, ``length_norm``, ...) is
swept; each combination decodes the dev set with the port's batched beam
(``decoding/beam.py``) and is scored on a deterministic split of the dev
utterances by utt-id hash (``in_holdout``: stable across runs and
configs). One JSON record per combination ({combo, tune_wer, tune_n,
holdout_wer, holdout_n}), then a ``tune_decode_done`` summary with the
combination the tune split picks and ITS holdout WER, the one honest
generalization number. ``--ckpt`` is a port checkpoint or a JAX
trainer's (``bridge.py``).
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import zlib

import torch

from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.decode import make_eval_loader, restore_model
from gluon_e2e_asr_tpu_torch.decoding.beam import make_beam_decoder
from gluon_e2e_asr_tpu_torch.eval.metrics import wer
from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets

_BOOL = {"true": True, "false": False}


def _parse_grid(items):
    """--grid key=v1,v2,... (repeatable) -> {key: [typed values]}."""
    grid = {}
    for it in items:
        key, _, vals = it.partition("=")
        if not vals:
            raise SystemExit(f"--grid wants key=v1,v2,...; got {it!r}")
        typed = []
        for v in vals.split(","):
            lv = v.strip().lower()
            if lv in _BOOL:
                typed.append(_BOOL[lv])
            else:
                try:
                    typed.append(int(v))
                except ValueError:
                    typed.append(float(v))
        grid[key.strip()] = typed
    return grid


def in_holdout(utt_id: str, frac: float) -> bool:
    """Deterministic utt-id-hash split, stable across runs/configs."""
    return (zlib.crc32(utt_id.encode()) % 1000) < int(frac * 1000)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="grid-search beam decode knobs on a tune/holdout split")
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--grid", action="append", default=[],
                    metavar="KEY=V1,V2,...",
                    help="decode.<KEY> values to sweep (repeatable)")
    ap.add_argument("--holdout-frac", type=float, default=0.5)
    ap.add_argument("--output", default="")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda (the kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    grid = _parse_grid(args.grid)
    if not grid:
        raise SystemExit("nothing to sweep: pass at least one --grid")

    config = load_config(args.config)
    apply_overrides(config, args.set)
    config.decode.method = "beam"
    device = torch.device(args.device)
    if device.type == "cuda":
        # The frontend's DFT and mel products must run in true f32.
        torch.backends.cuda.matmul.allow_tf32 = False

    model, cmvn_stats, tokenizer = restore_model(config, args.ckpt, device)
    _, dev_utts = build_datasets(config)
    loader = make_eval_loader(config, dev_utts, tokenizer)
    by_id = {u.utt_id: u for u in dev_utts}

    out_f = open(args.output, "w") if args.output else None
    rows = []
    keys = sorted(grid)
    for combo in itertools.product(*(grid[k] for k in keys)):
        cfg = copy.deepcopy(config)
        for k, v in zip(keys, combo):
            if not hasattr(cfg.decode, k):
                raise SystemExit(f"decode config has no knob {k!r}")
            setattr(cfg.decode, k, v)
        decoder = make_beam_decoder(model, cfg, tokenizer, cmvn_stats,
                                    device=device)
        split = {"tune": ([], []), "holdout": ([], [])}
        for b in loader.epoch(0):
            texts, _ = decoder(b.audio, b.audio_len)
            for row, utt_id in enumerate(b.utt_ids):
                name = ("holdout"
                        if in_holdout(utt_id, args.holdout_frac) else "tune")
                split[name][0].append(by_id[utt_id].text)
                split[name][1].append(texts[row])
        rec = {"combo": dict(zip(keys, combo))}
        for name, (refs, hyps) in split.items():
            rec[f"{name}_wer"] = round(wer(refs, hyps), 4) if refs else None
            rec[f"{name}_n"] = len(refs)
        rows.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if out_f:
            out_f.write(line + "\n")

    best = min(rows, key=lambda r: r["tune_wer"])
    summary = {
        "event": "tune_decode_done",
        "grid": grid,
        "holdout_frac": args.holdout_frac,
        "best_by_tune": best["combo"],
        "tune_wer": best["tune_wer"],
        # The holdout WER of the combo the tune split picked (NOT the best
        # holdout in the grid).
        "holdout_wer_of_best": best["holdout_wer"],
    }
    line = json.dumps(summary)
    print(line)
    if out_f:
        out_f.write(line + "\n")
        out_f.close()
    return summary


if __name__ == "__main__":
    main()
