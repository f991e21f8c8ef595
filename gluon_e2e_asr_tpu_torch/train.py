"""Train CLI: ``python -m gluon_e2e_asr_tpu_torch.train --config <yaml>
--set loss.mtl_alpha=1.0 [--device cuda]``.

Counterpart of ``gluon_e2e_asr_tpu/train.py`` for CTC-only training: the
same flags (``--config``, ``--workdir``, ``--max-steps``, ``--set``) and
``--device``. On a CUDA device the encoder runs the hand-written kernels
K1-fwd and K1-bwd and the loss K2 and K3; on the CPU their plain
versions. Writes ``<workdir>/metrics.jsonl`` and checkpoints under
``<workdir>/<train.ckpt_dir>/`` (``ckpt_<step>.pt``, ``best.pt``), which
``gluon_e2e_asr_tpu_torch.decode`` reads; prints one ``done`` JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from gluon_e2e_asr_tpu_torch.config import Config, apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.training.trainer import Trainer


def main(argv=None):
    p = argparse.ArgumentParser(description="E2E ASR training (PyTorch port)")
    p.add_argument("--config", type=str, default="", help="yaml config path")
    p.add_argument("--workdir", type=str, default=".", help="output directory")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint (not ported yet)")
    p.add_argument("--max-steps", type=int, default=0,
                   help="override train.max_steps (0 = keep config)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="dotted config override, e.g. loss.mtl_alpha=1.0 "
                        "(repeatable)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    args = p.parse_args(argv)
    if args.resume:
        raise NotImplementedError(
            "--resume: resuming from a checkpoint is not ported yet "
            "(ROADMAP.md)")

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if args.max_steps:
        config.train.max_steps = args.max_steps
    device = torch.device(args.device)
    if device.type == "cuda":
        # The frontend's DFT and mel products must run in true f32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    trainer = Trainer(config, workdir=args.workdir, device=device)
    final = trainer.train()
    print(json.dumps({"event": "done", "step": trainer.state.step, **final},
                     default=float))
    return trainer


if __name__ == "__main__":
    main()
