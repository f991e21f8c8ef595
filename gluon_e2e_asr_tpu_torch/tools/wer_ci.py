"""Bootstrap confidence intervals for WER/CER from per-utterance decode
JSONL records (what ``gluon_e2e_asr_tpu_torch.decode --output`` writes).

The port's own copy of the root ``tools/wer_ci.py`` (the port imports
nothing of the JAX package), over the port's ``eval/metrics.py``;
``tests/test_torch_convergence.py`` holds the two to the same code.
Resamples utterances with replacement and reports the 95% interval of
the aggregate corpus-level metric; ``--compare A B`` is the paired
bootstrap of WER(A) - WER(B) over the utterances both decode.

    python -m gluon_e2e_asr_tpu_torch.tools.wer_ci decode.jsonl [more ...]
    python -m gluon_e2e_asr_tpu_torch.tools.wer_ci --compare a.jsonl b.jsonl
"""

import argparse
import json

import numpy as np

from gluon_e2e_asr_tpu_torch.eval.metrics import edit_distance


def per_utt_counts(path, keyed=False):
    """[(word_errs, n_words, char_errs, n_chars)] per utterance.

    With ``keyed=True`` returns a {utt_id: row} dict instead (for paired
    comparisons aligned by utterance id rather than file order).
    """
    rows = [] if not keyed else {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            ref_w, hyp_w = r["ref"].split(), r["hyp"].split()
            row = (
                edit_distance(ref_w, hyp_w), len(ref_w),
                edit_distance(list(r["ref"]), list(r["hyp"])), len(r["ref"]),
            )
            if keyed:
                rows[r["utt_id"]] = row
            else:
                rows.append(row)
    return rows if keyed else np.asarray(rows, np.float64)


def bootstrap_ci(counts, iters=10000, seed=0):
    """(wer, wer_lo, wer_hi, cer, cer_lo, cer_hi) at 95%."""
    rng = np.random.default_rng(seed)
    n = len(counts)
    wer = counts[:, 0].sum() / max(counts[:, 1].sum(), 1.0)
    cer = counts[:, 2].sum() / max(counts[:, 3].sum(), 1.0)
    idx = rng.integers(0, n, size=(iters, n))
    s = counts[idx].sum(axis=1)  # [iters, 4]
    wers = s[:, 0] / np.maximum(s[:, 1], 1.0)
    cers = s[:, 2] / np.maximum(s[:, 3], 1.0)
    lo_w, hi_w = np.percentile(wers, [2.5, 97.5])
    lo_c, hi_c = np.percentile(cers, [2.5, 97.5])
    return wer, lo_w, hi_w, cer, lo_c, hi_c


def paired_diff_ci(counts_a, counts_b, iters=10000, seed=0):
    """Paired bootstrap of WER_a - WER_b over the SAME utterances.

    Pairing removes between-utterance variance, so the difference CI is
    far tighter than comparing two independent intervals — the honest
    test for same-checkpoint decoder comparisons (beam vs greedy).
    """
    assert len(counts_a) == len(counts_b), "paired compare needs same utts"
    rng = np.random.default_rng(seed)
    n = len(counts_a)
    d = (counts_a[:, 0].sum() / max(counts_a[:, 1].sum(), 1.0)
         - counts_b[:, 0].sum() / max(counts_b[:, 1].sum(), 1.0))
    idx = rng.integers(0, n, size=(iters, n))
    sa, sb = counts_a[idx].sum(axis=1), counts_b[idx].sum(axis=1)
    diffs = (sa[:, 0] / np.maximum(sa[:, 1], 1.0)
             - sb[:, 0] / np.maximum(sb[:, 1], 1.0))
    lo, hi = np.percentile(diffs, [2.5, 97.5])
    return d, lo, hi, float((diffs >= 0).mean())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("jsonl", nargs="*")
    p.add_argument("--iters", type=int, default=10000)
    p.add_argument("--compare", nargs=2, metavar=("A", "B"), default=None,
                   help="paired bootstrap of WER(A) - WER(B) on shared utts")
    args = p.parse_args(argv)
    if args.compare:
        ca = per_utt_counts(args.compare[0], keyed=True)
        cb = per_utt_counts(args.compare[1], keyed=True)
        shared = sorted(set(ca) & set(cb))
        assert len(shared) == len(ca) == len(cb), \
            "compare inputs decode different utterance sets"
        ca = np.asarray([ca[k] for k in shared], np.float64)
        cb = np.asarray([cb[k] for k in shared], np.float64)
        d, lo, hi, p_ge = paired_diff_ci(ca, cb, args.iters)
        print(json.dumps({
            "a": args.compare[0], "b": args.compare[1],
            "wer_diff_a_minus_b": round(d, 4),
            "diff_ci95": [round(lo, 4), round(hi, 4)],
            "p_diff_ge_0": round(p_ge, 4),
        }))
        return
    for path in args.jsonl:
        c = per_utt_counts(path)
        w, lw, hw, ce, lc, hc = bootstrap_ci(c, args.iters)
        print(json.dumps({
            "file": path,
            "num_utts": len(c),
            "wer": round(w, 4), "wer_ci95": [round(lw, 4), round(hw, 4)],
            "cer": round(ce, 4), "cer_ci95": [round(lc, 4), round(hc, 4)],
        }))


if __name__ == "__main__":
    main()
