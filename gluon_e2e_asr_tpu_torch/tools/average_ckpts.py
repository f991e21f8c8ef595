"""Average model parameters over several of the port's checkpoints.

    python -m gluon_e2e_asr_tpu_torch.tools.average_ckpts --out avg.pt \
        ckpt_100.pt ckpt_200.pt ...
    python -m gluon_e2e_asr_tpu_torch.tools.average_ckpts --out avg.pt \
        --last 3 --ckpt-dir <workdir>/<train.ckpt_dir>
    python -m gluon_e2e_asr_tpu_torch.tools.average_ckpts --out avg.pt \
        --best 3 --ckpt-dir <workdir>/<train.ckpt_dir>

Counterpart of the root ``tools/average_ckpts.py`` for the port's
checkpoints (``training/checkpoint.py``: a ``torch.save`` payload and its
``.json`` sidecar). Float parameter tensors are averaged elementwise (in
f64, cast back to their dtype); everything else comes from the NEWEST
input: the optimizer state, the step, the generator state and the CMVN
stats, so the result restores as a training checkpoint as well as a
decoding one. Its sidecar is the newest input's plus ``averaged_from``.
No model is built.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import torch

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pt$")


def _mean_params(all_params):
    """Elementwise mean of identical state dicts; float tensors only
    (others are taken from the newest, the last)."""
    out = {}
    for k, newest in all_params[-1].items():
        if torch.is_floating_point(newest):
            acc = torch.zeros(newest.shape, dtype=torch.float64)
            for p in all_params:
                acc += p[k].to(torch.float64)
            out[k] = (acc / len(all_params)).to(newest.dtype)
        else:
            out[k] = newest
    return out


def ordered_last_ckpts(ckpt_dir: str, n: int):
    """The ``n`` newest step-numbered checkpoints in a dir, oldest first."""
    found = []
    for fn in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fn)
        if m:
            found.append((int(m.group(1)), os.path.join(ckpt_dir, fn)))
    found.sort()
    return [p for _, p in found[-n:]]


def ordered_best_ckpts(ckpt_dir: str, n: int):
    """The ``n`` lowest-dev-WER checkpoints (sidecar ``dev_wer``), oldest
    first: the pool ``train.keep_policy=best`` retains. Checkpoints
    without a readable dev_wer (mid-epoch saves, a torn sidecar) are
    left out."""
    found = []
    for fn in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(fn)
        if not m:
            continue
        path = os.path.join(ckpt_dir, fn)
        try:
            with open(path + ".json") as f:
                w = float(json.load(f).get("dev_wer"))
        except (OSError, ValueError, TypeError, json.JSONDecodeError):
            w = None
        if w is not None:
            found.append((w, int(m.group(1)), path))
    found.sort()
    best = found[:n]
    return [p for _, _, p in sorted(best, key=lambda t: t[1])]


def average_checkpoints(paths, out_path: str) -> dict:
    """Average ``paths`` (oldest..newest) into ``out_path``. Returns the
    sidecar meta written next to it."""
    if len(paths) < 2:
        raise ValueError(f"need >= 2 checkpoints to average, got {paths}")
    payloads = [torch.load(p, map_location="cpu", weights_only=True)
                for p in paths]
    keys = payloads[-1]["params"].keys()
    for p, pl in zip(paths, payloads):
        if pl["params"].keys() != keys:
            raise ValueError(f"{p} holds other parameters than {paths[-1]}")
    out = dict(payloads[-1])
    out["params"] = _mean_params([pl["params"] for pl in payloads])
    tmp = out_path + ".tmp"
    torch.save(out, tmp)
    os.replace(tmp, out_path)
    meta = {}
    newest_meta = paths[-1] + ".json"
    if os.path.exists(newest_meta):
        with open(newest_meta) as f:
            meta = json.load(f)
    meta["averaged_from"] = [os.path.basename(p) for p in paths]
    mtmp = out_path + ".json.tmp"
    with open(mtmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(mtmp, out_path + ".json")
    return meta


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpts", nargs="*", help="checkpoint paths to average")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt-dir", default="",
                    help="with --last or --best: the directory holding "
                         "ckpt_<step>.pt")
    ap.add_argument("--last", type=int, default=0,
                    help="average the N newest step-numbered ckpts in "
                         "--ckpt-dir")
    ap.add_argument("--best", type=int, default=0,
                    help="average the N lowest-dev-WER ckpts in --ckpt-dir "
                         "(sidecar dev_wer; pairs with "
                         "train.keep_policy=best)")
    args = ap.parse_args(argv)
    paths = list(args.ckpts)
    if args.last > 0 and args.best > 0:
        ap.error("--last and --best are mutually exclusive")
    if (args.last > 0 or args.best > 0) and not args.ckpt_dir:
        ap.error("--last and --best require --ckpt-dir")
    if args.last > 0:
        paths = ordered_last_ckpts(args.ckpt_dir, args.last)
    if args.best > 0:
        paths = ordered_best_ckpts(args.ckpt_dir, args.best)
    meta = average_checkpoints(paths, args.out)
    summary = {
        "event": "average_ckpts",
        "inputs": [os.path.basename(p) for p in paths],
        "out": args.out,
        "step": meta.get("step"),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
