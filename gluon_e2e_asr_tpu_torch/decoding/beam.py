"""Batched beam search with CTC prefix scoring and length normalization.

Counterpart of ``gluon_e2e_asr_tpu/decoding/beam.py``, the same search
written out in PyTorch (the JAX beam holds no Pallas kernel):

- a fixed beam width K, vectorized over (batch, beam, vocabulary);
- CTC prefix scores kept as (nonblank, blank)-ending log-probability
  pairs r = (r_n, r_b) per hypothesis over encoder time, updated for all
  extensions at once by a loop over encoder time
  (``_ctc_extension_scores``);
- the joint ranking score (1-w) * attention log-probability sum + w * CTC
  prefix score, w = ``decode.ctc_weight`` (1 for ``ctc_beam``, which runs
  no decoder);
- eos extensions go to a finished buffer of K hypotheses, with length
  normalization and the insertion penalty at finalization; per-sample
  ``minlen_ratio`` / ``maxlen_ratio``; partial scoring
  (``decode.ctc_score_candidates``); ``decode.end_detect``; n-best;
- external-LM shallow fusion (``decode.lm_weight``, the LM of
  ``models/lm.py`` given as ``lm_bundle`` or read from
  ``decode.lm_ckpt``): each hypothesis accumulates lm_weight * log
  p_lm(y_i | y_<i), the LM fed the decoder's token stream with its state
  reordered by the same parents, and the LM's eos term enters the
  finalization score. At ``lm_weight`` 0 no LM code runs, so the search
  is bit-identical to the one without an LM.

The output steps loop while any beam is alive and fewer than
min(max maxlen, Lmax) steps ran, as the JAX ``while_loop`` does
(``beam.py:561-581`` there): a dead beam only yields -inf continuations
and never finalizes, so the result does not depend on how many steps
ran. Ties in every top-k go to the lower index, as ``jax.lax.top_k``
breaks them. With a ``World`` of ranks (``mesh``) each rank searches its
block of the batch's rows, with no collective inside the search, and the
rows come back in the batch's order (``fn.last_steps`` is the most any
rank ran), as the JAX ``shard_map`` beam does; each rank fuses the LM
into its own rows.

CTC prefix recursion (log space), extending prefix g by token c:
  phi[t]   = logaddexp(r_b(g)[t], c == last(g) ? -inf : r_n(g)[t])
  r_n(h)[t] = logaddexp(r_n(h)[t-1], phi[t-1]) + x[t, c]
  r_b(h)[t] = logaddexp(r_b(h)[t-1], r_n(h)[t-1]) + x[t, blank]
  psi(h)    = logsumexp_t(phi[t-1] + x[t, c])
with phi[-1] = 0 for the empty prefix, -inf otherwise; score(eos | g) =
the full CTC probability of g = logaddexp(r_n(g)[T_b-1], r_b(g)[T_b-1]).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import Config
from gluon_e2e_asr_tpu_torch.frontend.features import frontend_apply
from gluon_e2e_asr_tpu_torch.models.asr import ASRModel
from gluon_e2e_asr_tpu_torch.parallel.mesh import (
    SINGLE, World, gather_rows, shard_rows)

NEG_INF = -1.0e30


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _ctc_extension_scores(ctc_logp, enc_len, r_prev, last_tok, is_empty,
                          blank_id: int, cand: Optional[torch.Tensor] = None):
    """Scores for extending every (batch, beam) prefix by every token
    (``cand`` None: N = V) or by the N candidates ``cand`` [B,K,N].

    ctc_logp [B,T,V] (log-softmax of the CTC head), enc_len [B], r_prev
    [B,K,T,2] (r_n, r_b of the current prefixes), last_tok [B,K],
    is_empty [B,K]. Returns (psi [B,K,N], r_new [T,B,K,N,2], full_prob
    [B,K]). The loop stops at the batch's longest row: past it every row
    is masked and the state stays as it is."""
    B, T, V = ctc_logp.shape
    K = r_prev.shape[1]
    dev = ctc_logp.device
    xt = ctc_logp.transpose(0, 1)  # [T,B,V]
    xb = xt[:, :, None, blank_id:blank_id + 1]  # [T,B,1,1]
    if cand is None:
        xs = xt[:, :, None, :]  # [T,B,1,V]
        same_as_last = (torch.arange(V, device=dev)[None, None, :]
                        == last_tok[..., None])
    else:
        xs = torch.gather(ctc_logp[:, None].expand(B, K, T, V), 3,
                          cand[:, :, None, :].expand(B, K, T, cand.shape[-1])
                          ).permute(2, 0, 1, 3)  # [T,B,K,N]
        same_as_last = cand == last_tok[..., None]
    n_ext = xs.shape[-1]
    tmask = (torch.arange(T, device=dev)[:, None] < enc_len[None, :])[:, :, None, None]
    # r(g) at t-1, with the virtual row t = -1: (-inf, 0) for the empty
    # prefix, (-inf, -inf) otherwise.
    r_g = r_prev.permute(2, 0, 1, 3)  # [T,B,K,2]
    rm1 = torch.stack([torch.full((B, K), NEG_INF, device=dev),
                       torch.where(is_empty, 0.0, NEG_INF)], dim=-1)
    r_g_shift = torch.cat([rm1[None], r_g[:-1]], dim=0)
    r_n_h = torch.full((B, K, n_ext), NEG_INF, device=dev)
    r_b_h = torch.full((B, K, n_ext), NEG_INF, device=dev)
    psi = torch.full((B, K, n_ext), NEG_INF, device=dev)
    r_new = torch.empty(T, B, K, n_ext, 2, device=dev)
    t_end = int(enc_len.max()) if B else 0
    for t in range(min(t_end, T)):
        x_t, m_t = xs[t], tmask[t]
        r_n_g, r_b_g = r_g_shift[t, ..., 0:1], r_g_shift[t, ..., 1:2]
        phi = torch.logaddexp(r_b_g, torch.where(same_as_last, NEG_INF, r_n_g))
        r_n_new = torch.logaddexp(r_n_h, phi) + x_t
        r_b_new = torch.logaddexp(r_b_h, r_n_h) + xb[t]
        psi_new = torch.logaddexp(psi, phi + x_t)
        r_n_h = torch.where(m_t, r_n_new, r_n_h)
        r_b_h = torch.where(m_t, r_b_new, r_b_h)
        psi = torch.where(m_t, psi_new, psi)
        r_new[t, ..., 0], r_new[t, ..., 1] = r_n_h, r_b_h
    if t_end < T:
        r_new[t_end:, ..., 0], r_new[t_end:, ..., 1] = r_n_h, r_b_h
    # The full CTC probability of the current prefix g (for eos scoring).
    t_last = torch.clamp(enc_len - 1, min=0).long()
    r_at_end = torch.gather(r_prev, 2, t_last[:, None, None, None].expand(
        B, K, 1, 2))[:, :, 0]  # [B,K,2]
    full_prob = torch.logaddexp(r_at_end[..., 0], r_at_end[..., 1])
    return psi, r_new, full_prob


def make_beam_decoder(model: ASRModel, config: Config, tokenizer,
                      cmvn_stats=None, mesh: World = SINGLE, lm_bundle=None,
                      device: torch.device = torch.device("cpu")) -> Callable:
    """The batched beam decoder: fn(audio, audio_len) -> (texts, scores
    [B] np.float32), with ``fn.nbest(audio, audio_len)`` -> per utterance
    [(text, score)] * N, score-descending (slots past the finished
    hypotheses carry the NEG_INF sentinel), and ``fn.last_steps``, the
    output steps the last call ran. ``audio`` / ``audio_len`` are host
    arrays or tensors; the copy to ``device`` is part of the call. With
    ``mesh`` (a ``World`` of more than one rank) every rank returns the
    whole batch's results."""
    dc = config.decode
    K = dc.beam_size
    w = float(dc.ctc_weight)
    blank_id, sos_id = tokenizer.blank_id, tokenizer.sos_id
    eos_id, unk_id = tokenizer.eos_id, tokenizer.unk_id
    V = tokenizer.vocab_size
    # ctc_beam: no decoder; extensions ranked by the exact prefix
    # probability (w = 1), finalization by the full CTC probability.
    use_dec = dc.method != "ctc_beam"
    if not use_dec:
        w = 1.0
    if not model.use_decoder and use_dec:
        raise ValueError(
            "beam decoding requires the attention decoder (CTC-only "
            "models decode with method=greedy or method=ctc_beam)")
    n_best = max(1, min(int(getattr(dc, "nbest", 1)), K))
    penalty = float(getattr(dc, "penalty", 0.0))
    if penalty != 0.0 and dc.length_norm:
        logging.getLogger(__name__).warning(
            "decode.penalty=%g has almost no effect with "
            "decode.length_norm=true (the normalization divides the "
            "penalty term down to a near-constant offset); set "
            "length_norm: false to use the insertion penalty", penalty)
    use_end_detect = bool(getattr(dc, "end_detect", False))
    ed_m = int(getattr(dc, "end_detect_m", 3))
    ed_d = float(getattr(dc, "end_detect_d", 10.0))
    # External-LM shallow fusion: an LSTMLM (lm_bundle) or decode.lm_ckpt.
    lm_w = float(getattr(dc, "lm_weight", 0.0))
    use_lm = lm_w != 0.0
    lm = lm_bundle
    if use_lm:
        if lm is None:
            if not dc.lm_ckpt:
                raise ValueError(
                    "decode.lm_weight is set but no LM was provided: set "
                    "decode.lm_ckpt (a train_lm.py checkpoint) or pass "
                    "lm_bundle (an LSTMLM)")
            from gluon_e2e_asr_tpu_torch.models.lm import load_lm

            lm, lm_meta = load_lm(dc.lm_ckpt, device)
            if lm_meta.get("vocab") and lm_meta["vocab"] != tokenizer.to_json():
                raise ValueError(
                    "LM checkpoint vocab differs from the decode tokenizer "
                    "(same sizes, different symbol table): retrain the LM "
                    "on this vocab")
        if lm.vocab_size != V:
            raise ValueError(f"LM vocab_size {lm.vocab_size} != decode "
                             f"tokenizer vocab_size {V}")
        lm = lm.to(device).eval()
    n_cand = int(dc.ctc_score_candidates)
    use_partial = w > 0.0 and 0 < n_cand < V
    if w > 0.0 and not use_partial and V > 512:
        raise ValueError(
            f"full-vocab CTC prefix scoring at vocab_size={V} would "
            "materialize a [T,B,K,V,2] prefix state per step; set "
            "decode.ctc_score_candidates (e.g. 2*beam_size) to enable "
            "partial scoring")
    if use_partial and n_cand < K:
        raise ValueError(
            f"ctc_score_candidates={n_cand} must be >= beam_size={K} "
            "(each step keeps K continuations drawn from the candidates)")
    if cmvn_stats is not None:
        cmvn_stats = tuple(torch.as_tensor(s, dtype=torch.float32,
                                           device=device) for s in cmvn_stats)
    # blank/sos/eos/unk never continue a hypothesis (eos goes to the
    # finished buffer; unk is excluded from generation)
    bad = torch.zeros(V, dtype=torch.bool, device=device)
    bad[[blank_id, sos_id, eos_id, unk_id]] = True

    @torch.inference_mode()
    def device_fn(audio, audio_len):
        audio = torch.as_tensor(audio).to(device)
        audio_len = torch.as_tensor(audio_len).to(device)
        feats, feat_len = frontend_apply(config.frontend, audio, audio_len,
                                         cmvn_stats=cmvn_stats)
        enc, enc_len, ctc_logits = model.encode(feats, feat_len)
        B, T = enc.shape[0], enc.shape[1]
        Lmax = max(int(dc.maxlen_ratio * T), 4)
        ctc_logp = torch.log_softmax(ctc_logits.float(), dim=-1)
        ar = lambda n: torch.arange(n, device=device)  # noqa: E731
        enc_mask = (ar(T)[None, :] < enc_len[:, None]).float()
        if use_dec:
            # The encoder tensors stay [B,T,*]; only the decoder state
            # carries the beam axis.
            enc_proj = model.decoder_precompute(enc)
            loc_band = model.decoder_loc_band(T)  # built once
        static_cand = None
        if not use_dec and use_partial:
            # ctc_beam's candidates: the top-N tokens by best framewise
            # CTC posterior over the valid frames.
            t_ok = (ar(T)[None, :] < enc_len[:, None])[..., None]
            post_max = torch.where(t_ok, ctc_logp, NEG_INF).max(dim=1).values
            post_max = torch.where(bad[None, :], NEG_INF, post_max)
            static_cand = _top_k(post_max, n_cand)[1][:, None, :].expand(
                B, K, n_cand)
        f32_len = enc_len.float()
        maxlen = torch.clamp((dc.maxlen_ratio * f32_len).int(), min=1)
        minlen = (dc.minlen_ratio * f32_len).int()

        # CTC prefix state of the empty prefix: r_b[t] = sum_{tau<=t} x[tau,b].
        xb_cum = torch.cumsum(ctc_logp[:, :, blank_id], dim=1)
        r0 = torch.stack([torch.full((B, T), NEG_INF, device=device), xb_cum],
                         dim=-1)[:, None].repeat(1, K, 1, 1)
        c = {
            "tokens": torch.zeros(B, K, Lmax, dtype=torch.long, device=device),
            "hyp_len": torch.zeros(B, K, dtype=torch.long, device=device),
            "att_sum": torch.where(ar(K)[None, :] == 0, 0.0, NEG_INF)
            .expand(B, K).contiguous(),
            "r": r0,
            "last_tok": torch.full((B, K), -1, dtype=torch.long, device=device),
            "fin_tokens": torch.zeros(B, K, Lmax, dtype=torch.long,
                                      device=device),
            "fin_len": torch.zeros(B, K, dtype=torch.long, device=device),
            "fin_score": torch.full((B, K), NEG_INF, device=device),
            "best_raw": torch.full((B,), NEG_INF, device=device),
            "end_cnt": torch.zeros(B, dtype=torch.long, device=device),
        }
        if use_dec:
            c["dec_state"] = model.decoder_init_state_beam(B, K, T)
        if use_lm:
            c["lm_state"] = lm.init_state(B * K)
            c["lm_sum"] = torch.zeros(B, K, device=device)
        rows = ar(B)[:, None]

        def step(c, i):
            tok_in = torch.where(c["last_tok"] < 0, sos_id,
                                 c["last_tok"]).reshape(B * K)
            if use_dec:
                dec_state, logits = model.decoder_step_beam(
                    c["dec_state"], tok_in, enc, enc_proj, enc_mask, K,
                    loc_band)
                att_logp = torch.log_softmax(logits, dim=-1).view(B, K, V)
            else:
                # att_logp enters with weight (1-w) == 0; zeros keep att_sum
                # a liveness tracker (0 alive, NEG_INF dead).
                att_logp = torch.zeros(B, K, V, device=device)
            if use_lm:
                # The LM reads the decoder's token stream (sos, then each
                # chosen extension); its state follows the same parents.
                lm_state, lm_logits = lm.step(c["lm_state"], tok_in)
                lm_total = c["lm_sum"][..., None] + torch.log_softmax(
                    lm_logits, dim=-1).view(B, K, V)
            cand = None
            if use_partial and use_dec:
                pre = torch.where(bad, NEG_INF, att_logp)
                cand = _top_k(pre, n_cand)[1]  # [B,K,N]
            elif use_partial:
                cand = static_cand
            if w > 0.0:
                psi, r_new, full_prob = _ctc_extension_scores(
                    ctc_logp, enc_len, c["r"], c["last_tok"],
                    c["last_tok"] < 0, blank_id, cand)
            else:
                psi, r_new = torch.zeros(B, K, V, device=device), None
                full_prob = torch.zeros(B, K, device=device)

            att_total = c["att_sum"][..., None] + att_logp  # [B,K,V]
            if use_partial:
                att_cont = torch.gather(att_total, 2, cand)
                tok_bad = bad[cand]
            else:
                att_cont, tok_bad = att_total, bad.expand(B, K, V)
            joint = (1.0 - w) * att_cont + w * psi
            if use_lm:
                lm_cont = (torch.gather(lm_total, 2, cand) if use_partial
                           else lm_total)
                joint = joint + lm_w * lm_cont

            # eos candidates -> the finished buffer (length-normalized)
            eos_score = ((1.0 - w) * att_total[..., eos_id] + w * full_prob
                         + penalty * c["hyp_len"].float())
            if use_lm:
                eos_score = eos_score + lm_w * lm_total[..., eos_id]
            new_len = c["hyp_len"] + 1  # includes eos
            fin_cand = (eos_score / new_len.float() if dc.length_norm
                        else eos_score)
            alive = c["att_sum"] > NEG_INF / 2
            can_fin = (c["hyp_len"] >= minlen[:, None]) & alive
            fin_cand = torch.where(can_fin, fin_cand, NEG_INF)
            # end detection on raw (unnormalized) scores
            mx_raw = torch.where(can_fin, eos_score, NEG_INF).max(dim=1).values
            best_raw = torch.maximum(c["best_raw"], mx_raw)
            ended = (mx_raw < best_raw - ed_d) & (best_raw > NEG_INF / 2)
            end_cnt = torch.where(ended, c["end_cnt"] + 1, 0)
            top_fin, fin_idx = _top_k(
                torch.cat([c["fin_score"], fin_cand], dim=1), K)
            all_tokens = torch.cat([c["fin_tokens"], c["tokens"]], dim=1)
            fin_tokens = torch.gather(all_tokens, 1, fin_idx[..., None].expand(
                B, K, Lmax))
            fin_len = torch.gather(torch.cat([c["fin_len"], c["hyp_len"]], 1),
                                   1, fin_idx)

            # continuations: dead slots, specials, maxlen, end detection and
            # the token buffer's end closed
            cont = torch.where(alive[..., None], joint, NEG_INF)
            cont = torch.where(tok_bad, NEG_INF, cont)
            cont = torch.where((i + 1 >= maxlen)[:, None, None], NEG_INF, cont)
            if use_end_detect:
                cont = torch.where((end_cnt >= ed_m)[:, None, None], NEG_INF,
                                   cont)
            cont = torch.where((c["hyp_len"] >= Lmax)[..., None], NEG_INF, cont)

            n_ext = cont.shape[-1]
            top_scores, top_idx = _top_k(cont.reshape(B, K * n_ext), K)
            parent = top_idx // n_ext
            token = (torch.gather(cand.reshape(B, K * n_ext), 1, top_idx)
                     if use_partial else top_idx % n_ext)
            live = top_scores > NEG_INF / 2
            tokens = torch.gather(c["tokens"], 1, parent[..., None].expand(
                B, K, Lmax))
            hyp_len = torch.gather(c["hyp_len"], 1, parent)
            tokens = torch.where((ar(Lmax)[None, None, :] == hyp_len[..., None])
                                 & live[..., None], token[..., None], tokens)
            hyp_len = hyp_len + live.long()
            att_sum = torch.gather(att_cont.reshape(B, K * n_ext), 1, top_idx)
            att_sum = torch.where(live, att_sum, NEG_INF)
            if w > 0.0:
                # r of each chosen (parent, token): [T,B,K,2] -> [B,K,T,2]
                r = r_new.view(T, B, K * n_ext, 2)[:, rows, top_idx]
                r = r.permute(1, 2, 0, 3)
            else:
                r = c["r"]
            new = {"tokens": tokens, "hyp_len": hyp_len, "att_sum": att_sum,
                   "r": r, "last_tok": token, "fin_tokens": fin_tokens,
                   "fin_len": fin_len, "fin_score": top_fin,
                   "best_raw": best_raw, "end_cnt": end_cnt}
            flat_parent = (parent + rows * K).reshape(B * K)
            if use_dec:
                new["dec_state"] = {
                    "h": dec_state["h"][:, flat_parent],
                    "c": dec_state["c"][:, flat_parent],
                    "att_w": torch.gather(dec_state["att_w"], 1,
                                          parent[..., None].expand(B, K, T)),
                    "context": dec_state["context"][flat_parent],
                }
            if use_lm:
                new["lm_sum"] = torch.gather(lm_cont.reshape(B, K * n_ext), 1,
                                             top_idx)
                new["lm_state"] = {"h": lm_state["h"][:, flat_parent],
                                   "c": lm_state["c"][:, flat_parent]}
            return new

        # Past every sample's maxlen all continuations are -inf and the
        # finished buffer no longer changes, and once every beam is dead the
        # state is a fixpoint: stopping there is exact.
        max_steps = min(int(maxlen.max()), Lmax) if B else 0
        i = 0
        while i < max_steps and bool((c["att_sum"] > NEG_INF / 2).any()):
            c = step(c, i)
            i += 1
        # Top-N finished hypotheses per sample, score-descending (a stable
        # sort: N=1 is the 1-best).
        order = torch.argsort(-c["fin_score"], dim=1, stable=True)[:, :n_best]
        nb_tokens = torch.gather(c["fin_tokens"], 1, order[..., None].expand(
            B, n_best, Lmax))
        nb_len = torch.gather(c["fin_len"], 1, order)
        nb_score = torch.gather(c["fin_score"], 1, order)
        return nb_tokens.cpu().numpy(), nb_len.cpu().numpy(), \
            nb_score.cpu().numpy(), i

    def search(audio, audio_len):
        """device_fn over this rank's rows, the rows of every rank after."""
        if mesh.size == 1:
            return device_fn(audio, audio_len)
        tokens, lens, scores, steps = device_fn(
            shard_rows(audio, mesh.rank, mesh.size),
            shard_rows(audio_len, mesh.rank, mesh.size))
        return (*(gather_rows(a, mesh) for a in (tokens, lens, scores)),
                max(gather_rows([steps], mesh)))

    def decode(audio, audio_len):
        tokens, lens, scores, steps = search(audio, audio_len)
        decode.last_steps = steps
        texts = [tokenizer.decode(tokens[b, 0, :int(lens[b, 0])])
                 for b in range(tokens.shape[0])]
        return texts, np.asarray(scores)[:, 0]

    def decode_nbest(audio, audio_len):
        tokens, lens, scores, steps = search(audio, audio_len)
        decode.last_steps = steps
        return [[(tokenizer.decode(tokens[b, n, :int(lens[b, n])]),
                  float(scores[b, n])) for n in range(tokens.shape[1])]
                for b in range(tokens.shape[0])]

    decode.nbest = decode_nbest
    decode.last_steps = None
    return decode
