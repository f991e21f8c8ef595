"""Greedy CTC decoding. Counterpart of
``gluon_e2e_asr_tpu/decoding/greedy.py``: frontend -> encoder ->
framewise argmax -> collapse on the device; the host only
detokenizes. With a ``World`` of ranks (``mesh``), each rank decodes its
block of the batch's rows, with no collective inside, and the rows come
back in the batch's order on every rank."""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import Config
from gluon_e2e_asr_tpu_torch.frontend.features import frontend_apply
from gluon_e2e_asr_tpu_torch.models.asr import ASRModel
from gluon_e2e_asr_tpu_torch.ops.ctc import ctc_greedy_decode
from gluon_e2e_asr_tpu_torch.parallel.mesh import (
    SINGLE, World, gather_rows, shard_rows)


def make_greedy_decoder(model: ASRModel, config: Config, cmvn_stats=None,
                        device: torch.device = torch.device("cpu"),
                        mesh: World = SINGLE) -> Callable:
    """Returns fn(audio, audio_len) -> (ids [B,T'], lens [B]) on
    ``device``. ``audio`` / ``audio_len`` are host arrays (or tensors);
    the copy to the device is part of the call. With ``mesh`` (a
    ``World`` of more than one rank) every rank returns the whole batch's
    ids, gathered on the host, where the caller turns them into text."""
    if cmvn_stats is not None:
        cmvn_stats = tuple(torch.as_tensor(s, dtype=torch.float32,
                                           device=device) for s in cmvn_stats)

    @torch.inference_mode()
    def decode_fn(audio, audio_len):
        audio = torch.as_tensor(audio).to(device)
        audio_len = torch.as_tensor(audio_len).to(device)
        feats, feat_len = frontend_apply(config.frontend, audio, audio_len,
                                         cmvn_stats=cmvn_stats)
        _, enc_len, ctc_logits = model.encode(feats, feat_len)
        return ctc_greedy_decode(ctc_logits, enc_len, blank_id=0)

    if mesh.size == 1:
        return decode_fn

    def sharded_fn(audio, audio_len):
        ids, lens = decode_fn(shard_rows(audio, mesh.rank, mesh.size),
                              shard_rows(audio_len, mesh.rank, mesh.size))
        return tuple(torch.from_numpy(gather_rows(t.cpu().numpy(), mesh))
                     for t in (ids, lens))

    return sharded_fn


def ids_to_texts(ids, lens, tokenizer) -> List[str]:
    out = []
    for row, n in zip(np.asarray(ids), np.asarray(lens)):
        out.append(tokenizer.decode(row[: int(n)]))
    return out
