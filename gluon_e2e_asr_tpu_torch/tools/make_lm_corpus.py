"""Build the shallow-fusion LM text corpus of an english-fixture config:
the checked-in English pool minus every sentence that holds a dev
transcript.

    python -m gluon_e2e_asr_tpu_torch.tools.make_lm_corpus \
        --config configs/english_m5.yaml --out <dir>/lm_corpus.txt
    python -m gluon_e2e_asr_tpu_torch.train_lm \
        --config configs/english_m5.yaml --workdir <dir> \
        --set lm.extra_text=<dir>/lm_corpus.txt

Counterpart of the JAX package's ``tools/make_lm_corpus.py``. The dev
transcripts are word windows drawn from the same pool, so unfiltered
pool text would leak dev word sequences into the LM. With
``data.synth_split: sentence`` the corpus is the train side of the pool,
which holds no dev window by construction; the filter still runs and
must drop nothing (it raises otherwise).
"""

from __future__ import annotations

import argparse

from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.data.manifest import english_pool, english_pool_split
from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    args = p.parse_args(argv)

    config = load_config(args.config)
    apply_overrides(config, args.set)
    _, dev_utts = build_datasets(config)
    dev_texts = [u.text for u in dev_utts]
    disjoint = config.data.synth_split == "sentence"
    pool = english_pool_split("train") if disjoint else english_pool()
    kept = [ln for ln in pool if not any(t in ln for t in dev_texts)]
    if disjoint and len(kept) != len(pool):
        raise AssertionError(
            f"sentence split promised zero dev-window leakage but the "
            f"filter dropped {len(pool) - len(kept)} train-side sentences")
    with open(args.out, "w") as f:
        f.write("\n".join(kept) + "\n")
    print(f"LM corpus: kept {len(kept)}/{len(pool)} pool sentences "
          f"(dropped {len(pool) - len(kept)} containing a dev window) "
          f"-> {args.out}")
    return {"kept": len(kept), "pool": len(pool), "out": args.out}


if __name__ == "__main__":
    main()
