"""Interactive-serving decode policy. Counterpart of
``gluon_e2e_asr_tpu/decoding/serving.py``.

At B=1 the joint beam is bound by its sequence of small dependent steps,
so per-step work and the step count are the levers. The two safe levers
ship as serving defaults:

- partial CTC scoring (``decode.ctc_score_candidates = 2*beam_size``):
  narrows the per-step prefix-score loop from V columns to ~2K,
- end-detect early stopping (``decode.end_detect``): stops the output
  loop once every recent ending is ``end_detect_d`` below the best
  finished score instead of running to maxlen.

Applied only when the effective batch size is 1 and the method is a
beam; explicit user overrides always win.
"""

from __future__ import annotations

import sys
from typing import Iterable

from gluon_e2e_asr_tpu_torch.config import Config


def apply_b1_serving_defaults(
    config: Config,
    cli_overrides: Iterable[str] = (),
    batch_size: int = None,
) -> None:
    """Mutate ``config.decode`` with the B=1 serving defaults."""
    bs = config.data.batch_size if batch_size is None else int(batch_size)
    if bs != 1 or config.decode.method not in ("beam", "ctc_beam"):
        return
    # dynamic_batch scales per-bucket sizes UP from batch_size (shorter
    # buckets pack more utterances), so batch_size==1 does not imply the
    # effective batch is 1: no B=1 policy for multi-utterance batches.
    if batch_size is None and config.data.dynamic_batch:
        return
    overridden = {k.split("=", 1)[0] for k in (cli_overrides or ())}
    if (config.decode.ctc_score_candidates == 0
            and "decode.ctc_score_candidates" not in overridden):
        config.decode.ctc_score_candidates = 2 * config.decode.beam_size
        print(f"decode: B=1 serving default -> "
              f"ctc_score_candidates={config.decode.ctc_score_candidates}",
              file=sys.stderr)
    if (not config.decode.end_detect
            and "decode.end_detect" not in overridden):
        config.decode.end_detect = True
        print("decode: B=1 serving default -> end_detect=true",
              file=sys.stderr)
