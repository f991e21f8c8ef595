"""Train and then decode each milestone config end to end, printing a
``milestone_done`` line per config and an ``all_milestones`` summary.

    python -m gluon_e2e_asr_tpu_torch.tools.run_milestones \
        [--workdir <dir>] [--only 1,2] [--device cuda|cpu]

Counterpart of the root ``tools/run_milestones.py``: each config (as
shipped) through the port's ``Trainer`` into ``<workdir>/m<N>``, then its
``best.pt`` through ``decode.main`` by the config's ``decode.method``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = [
    ("m1", "configs/milestone1_bilstm_ctc.yaml"),
    ("m2", "configs/milestone2_fused_frontend.yaml"),
    ("m3", "configs/milestone3_las.yaml"),
    ("m4", "configs/milestone4_hybrid_dp.yaml"),
    ("m5", "configs/milestone5_beam.yaml"),
]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default="milestones")
    p.add_argument("--only", default="",
                   help="comma-separated milestone numbers, e.g. 1,5")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    args = p.parse_args(argv)
    only = {f"m{s.strip()}" for s in args.only.split(",") if s.strip()}

    from gluon_e2e_asr_tpu_torch import decode as decode_cli
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.training.trainer import Trainer

    device = torch.device(args.device)
    if device.type == "cuda":
        # The frontend's DFT and mel products must run in true f32.
        torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    for name, cfg_path in CONFIGS:
        if only and name not in only:
            continue
        cfg_path = os.path.join(REPO, cfg_path)
        wd = os.path.join(args.workdir, name)
        os.makedirs(wd, exist_ok=True)
        config = load_config(cfg_path)
        t0 = time.perf_counter()
        trainer = Trainer(config, workdir=wd, device=device)
        final = trainer.train()
        train_time = time.perf_counter() - t0
        ckpt = os.path.join(wd, config.train.ckpt_dir, "best.pt")
        dec = decode_cli.main([
            "--config", cfg_path, "--ckpt", ckpt,
            "--output", os.path.join(wd, "decode.jsonl"),
            "--device", args.device,
        ])
        row = {
            "milestone": name,
            "train_steps": final.get("step"),
            "train_time_s": round(train_time, 1),
            "utt_per_sec_per_chip": final.get("utt_per_sec_per_chip"),
            "dev_wer": dec["wer"],
            "dev_cer": dec["cer"],
            "p50_latency_s": dec["p50_latency_s"],
            "method": dec["method"],
        }
        results.append(row)
        print(json.dumps({"event": "milestone_done", **row}), flush=True)
    print(json.dumps({"event": "all_milestones", "results": results},
                     indent=2))
    return results


if __name__ == "__main__":
    main()
