"""LSTM language model for shallow-fusion beam decoding and n-best
rescoring.

Counterpart of ``gluon_e2e_asr_tpu/models/lm.py``: a token LSTM LM
(embed -> stacked LSTM -> vocabulary logits) trained on transcript text
by ``train_lm.py``. The JAX LM is ``lstm_scan`` over plain XLA ops (no
Pallas kernel), so the port is plain torch: the teacher-forced pass
projects every position's input in one [B*L, E] @ [E, 4H] product per
layer and loops only the recurrent update (``models/lstm.py::
lstm_scan``); the beam feeds one token a step through ``step``, which
carries (h, c) for each of its B*K rows. The parameters keep their flax
names and layouts (``embed`` [V, E], ``cell{l}_wx`` [in, 4H],
``cell{l}_b`` [4H], ``cell{l}_wh`` [H, 4H], ``out_w`` [H, V], ``out_b``
[V]; gate order (i, f, g, o), forget bias +1 inside the cell), so
``bridge.py`` maps them by name. Everything is f32, with true f32
matmuls on the card (TF32 off, or the LM raises).

Checkpoints are ``torch.save({"params": state_dict})`` with the JAX
package's JSON sidecar (``vocab_size``, ``embed_dim``, ``hidden``,
``layers``, ``vocab``, ``dev_ppl``, ``epoch``). ``load_lm`` also reads a
JAX ``train_lm.py`` checkpoint (a flax msgpack) through ``bridge.py``'s
reader; it tells the two apart by their first bytes.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gluon_e2e_asr_tpu_torch.models.encoder import lecun_normal_
from gluon_e2e_asr_tpu_torch.models.lstm import lstm_cell_step, lstm_scan
from gluon_e2e_asr_tpu_torch.ops.onehot import embed

_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's archive format


def _check_f32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the LM needs true f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


class LSTMLM(nn.Module):
    """Token LSTM LM. Inputs start with ``sos``; targets are the
    transcript tokens followed by ``eos``, so ``log p(eos | y)`` comes
    from the same projection that scores continuations (the beam's
    fused eos term)."""

    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 hidden: int = 512, layers: int = 2):
        super().__init__()
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.hidden, self.layers = hidden, layers
        V, E, H = vocab_size, embed_dim, hidden
        self.embed = nn.Parameter(torch.zeros(V, E))
        in_dims = [E] + [H] * (layers - 1)
        for layer in range(layers):
            setattr(self, f"cell{layer}_wx",
                    nn.Parameter(torch.zeros(in_dims[layer], 4 * H)))
            setattr(self, f"cell{layer}_b", nn.Parameter(torch.zeros(4 * H)))
            setattr(self, f"cell{layer}_wh", nn.Parameter(torch.zeros(H, 4 * H)))
        self.out_w = nn.Parameter(torch.zeros(H, V))
        self.out_b = nn.Parameter(torch.zeros(V))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initializers: normal(1/sqrt(E)) for ``embed``,
        lecun_normal for ``*_wx`` and ``out_w``, orthogonal for ``*_wh``,
        zeros for the biases. The same distributions as the JAX LM's
        ``lm.seed`` draws, not the same numbers."""
        for name, p in self.named_parameters():
            if name == "embed":
                p.normal_(0.0, 1.0 / math.sqrt(self.embed_dim),
                          generator=generator)
            elif name.endswith("_wh"):
                nn.init.orthogonal_(p, generator=generator)
            elif name.endswith("_b"):
                p.zero_()
            else:
                lecun_normal_(p, generator)

    def cells(self):
        """Each layer's (w_x, b, w_h)."""
        return tuple((getattr(self, f"cell{layer}_wx"),
                      getattr(self, f"cell{layer}_b"),
                      getattr(self, f"cell{layer}_wh"))
                     for layer in range(self.layers))

    def forward(self, tokens_in: torch.Tensor, lens: torch.Tensor
                ) -> torch.Tensor:
        """Teacher-forced pass: tokens_in [B, L] (position 0 = sos), lens
        [B] (valid input positions) -> logits [B, L, V]; positions past
        ``lens`` see zero LSTM outputs, as in JAX."""
        _check_f32(self.embed)
        x = embed(self.embed, tokens_in)  # [B, L, E]
        for w_x, b, w_h in self.cells():
            x = lstm_scan(torch.matmul(x, w_x) + b, lens, w_h)
        return torch.matmul(x, self.out_w) + self.out_b

    def init_state(self, n: int) -> Dict[str, torch.Tensor]:
        z = torch.zeros(self.layers, n, self.hidden, device=self.embed.device)
        return {"h": z, "c": z.clone()}

    def step(self, state: Dict[str, torch.Tensor], token: torch.Tensor
             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """One step of [n] flattened rows (the beam's B*K): token [n] ->
        (the new state, logits [n, V])."""
        _check_f32(self.embed)
        x = self.embed[token.long()]
        hs, cs = [], []
        for layer, (w_x, b, w_h) in enumerate(self.cells()):
            h, c = lstm_cell_step(state["h"][layer], state["c"][layer],
                                  torch.matmul(x, w_x) + b, w_h)
            hs.append(h)
            cs.append(c)
            x = h
        logits = torch.matmul(x, self.out_w) + self.out_b
        return {"h": torch.stack(hs), "c": torch.stack(cs)}, logits


def build_lm(config, vocab_size: int) -> LSTMLM:
    lc = config.lm
    return LSTMLM(vocab_size=vocab_size, embed_dim=lc.embed_dim,
                  hidden=lc.hidden, layers=lc.layers)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def save_lm(path: str, params: Dict[str, torch.Tensor],
            meta: Dict[str, Any]) -> str:
    """``meta`` carries the architecture (vocab_size, embed_dim, hidden,
    layers) and should carry the vocab JSON, which the beam checks
    against its tokenizer. Written to a temporary name, then renamed."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"params": {k: v.detach().cpu() for k, v in params.items()}},
               tmp)
    os.replace(tmp, path)
    meta_tmp = path + ".json.tmp"
    with open(meta_tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(meta_tmp, path + ".json")
    return path


def load_lm(path: str, device: torch.device = torch.device("cpu")
            ) -> Tuple[LSTMLM, Dict[str, Any]]:
    """(model on ``device`` in eval mode, meta) of a ``save_lm``
    checkpoint of the port or of the JAX package's ``train_lm.py``."""
    from gluon_e2e_asr_tpu_torch import bridge

    with open(path + ".json") as f:
        meta = json.load(f)
    model = LSTMLM(vocab_size=int(meta["vocab_size"]),
                   embed_dim=int(meta["embed_dim"]),
                   hidden=int(meta["hidden"]), layers=int(meta["layers"]))
    with open(path, "rb") as f:
        magic = f.read(len(_ZIP_MAGIC))
    if magic == _ZIP_MAGIC:
        state = torch.load(path, map_location="cpu", weights_only=True)["params"]
    else:
        state = bridge.lm_params_from_jax(bridge.read_jax_lm_checkpoint(path))
    model.load_state_dict(state)
    return model.to(device).eval(), meta


# ---------------------------------------------------------------------------
# Sequence log-probabilities (n-best rescoring, tests)
# ---------------------------------------------------------------------------

@torch.no_grad()
def lm_logprob_batch(model: LSTMLM, token_rows: Sequence[Sequence[int]],
                     eos_id: int, sos_id: int, pad_to: int = 16,
                     max_rows: int = 2048) -> np.ndarray:
    """log p(y, eos | sos) of every id row [n] f32. Rows pad to a shared
    length rounded up to a multiple of ``pad_to`` and go through the
    model in chunks of ``max_rows`` (with more rows than that, every
    chunk, the last too, is padded to ``max_rows`` rows: one chunk shape),
    because one pass over every row materializes [n, L, V] f32 logits
    (27,000 rescoring candidates took 16.5 GB)."""
    n = len(token_rows)
    if n == 0:
        return np.zeros((0,), np.float32)
    dev = model.embed.device
    L = max(len(r) for r in token_rows) + 1  # +1 for the eos target
    L = ((L + pad_to - 1) // pad_to) * pad_to
    out = np.zeros((n,), np.float32)
    for start in range(0, n, max_rows):
        rows = token_rows[start: start + max_rows]
        m = len(rows)
        mp = max_rows if n > max_rows else m  # stable chunk shape
        tokens_in = np.zeros((mp, L), np.int64)
        targets = np.zeros((mp, L), np.int64)
        lens = np.zeros((mp,), np.int64)
        for i, row in enumerate(rows):
            ids = [int(t) for t in row][: L - 1]
            tokens_in[i, : len(ids) + 1] = [sos_id] + ids
            targets[i, : len(ids) + 1] = ids + [eos_id]
            lens[i] = len(ids) + 1
        tin, tgt, ln = (torch.from_numpy(a).to(dev)
                        for a in (tokens_in, targets, lens))
        logp = torch.log_softmax(model(tin, ln), dim=-1)
        tok_lp = torch.gather(logp, 2, tgt[..., None])[..., 0]
        mask = torch.arange(L, device=dev)[None, :] < ln[:, None]
        out[start: start + m] = (tok_lp * mask).sum(dim=1).cpu().numpy()[:m]
    return out


@torch.no_grad()
def lm_logprob(model: LSTMLM, tokens: Sequence[int], eos_id: int,
               sos_id: int) -> float:
    """log p(y, eos | sos) of one unpadded id row, summed on the host."""
    ids = [int(t) for t in tokens]
    dev = model.embed.device
    tokens_in = torch.tensor([[sos_id] + ids], device=dev)
    logits = model(tokens_in, torch.tensor([len(ids) + 1], device=dev))[0]
    logp = torch.log_softmax(logits, dim=-1).cpu()
    return float(sum(logp[i, t] for i, t in enumerate(ids + [eos_id])))
