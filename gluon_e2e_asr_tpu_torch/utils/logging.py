"""Structured JSONL metrics logging [SURVEY.md §5 metrics/observability].

The port's own copy of ``gluon_e2e_asr_tpu/utils/logging.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_data.py`` holds the
two to the same results.

Train events: {step, epoch, loss, loss_ctc, loss_att, grad_norm, lr,
utt_per_sec_per_chip, tokens_per_sec}. Decode events: per-utterance
records {utt_id, hyp, score, latency_s} feeding WER and p50 latency
[BASELINE.json:L2].
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class JsonlLogger:
    def __init__(self, path: Optional[str] = None, also_stdout: bool = True,
                 mode: str = "a"):
        self.path = path
        self.also_stdout = also_stdout
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, mode, buffering=1)

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("ts", round(time.time(), 3))
        line = json.dumps(record, default=float)
        if self._fh:
            self._fh.write(line + "\n")
        if self.also_stdout:
            print(line, file=sys.stdout, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def percentile(values, q: float) -> float:
    """Simple percentile (nearest-rank) for latency reporting."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q / 100.0 * (len(vs) - 1)))))
    return float(vs[idx])
