"""The teacher-forced LAS decoder over L steps: K4-fwd and K4-bwd.

Counterpart of ``gluon_e2e_asr_tpu/ops/pallas_decoder.py::
las_decoder_fused`` (forward ``las_decoder_fwd``, VJP
``las_decoder_bwd``). Each step: the embedding of the step's token (the
gold one, or the previous step's argmax where the scheduled-sampling
coin says so), one LSTM cell on [embedding; previous context], the
attention query, the masked softmax over the encoder frames, the
context, and the output logits. Each direction has two versions:

- plain PyTorch: ``las_decoder_fwd_plain`` (a loop over
  ``decoder_step``, which ``models/decoder.py`` also uses for one step)
  and ``las_decoder_bwd_plain`` (an explicit reverse loop with the TPU
  backward kernel's formulas, not autograd). The CPU path, and the
  references the kernels are held against on the card. They do ``dot``
  and ``add`` attention.
- hand-written Hopper kernels: ``las_decoder_fwd_kernel`` and
  ``las_decoder_bwd_kernel`` (``csrc/las_decoder.cu``), ``dot``
  attention only; ``add`` on a CUDA tensor raises.

``las_decoder`` dispatches on the device of ``enc`` (``_route``): the
plain versions for a CPU tensor, the kernels for a CUDA tensor, and
nothing else; with gradients enabled it runs through ``LASDecoderFused``,
a ``torch.autograd.Function`` whose forward and backward dispatch the
same way. The weight gradients that the JAX package computes outside its
kernel as XLA einsums (``pallas_decoder.py:856-869``) are
``torch.matmul`` / ``index_add_`` here, for both routes; the gradient of
``enc_proj`` is accumulated inside the kernels.

Precision (``pallas_decoder.py:30-35``): every product takes operands
rounded to ``compute_dtype`` and sums in f32; state, softmax and gate
math stay f32. The dot-attention scores multiply the rounded
``enc_proj`` by the f32 query, as the TPU kernel does. Gate order
(i, f, g, o) with the forget bias +1 inside the cell. The TPU's
``_T_CHUNK`` padding and VMEM admission (``pick_block_batch``) have no
counterpart: a shape the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple

import torch

from gluon_e2e_asr_tpu_torch import _build

NEG = -1e30
ATT_KINDS = ("dot", "add")
MAX_HIDDEN = 1024


class Weights(NamedTuple):
    """The decoder's parameters in the JAX layouts: embed [V,E], w_x
    [E+D,4H], b_x [4H], w_h [H,4H], att_q [H,A], att_b [A], att_v [A,1]
    (zeros for dot attention), w_out [H+D,V], b_out [V]."""
    embed: torch.Tensor
    w_x: torch.Tensor
    b_x: torch.Tensor
    w_h: torch.Tensor
    att_q: torch.Tensor
    att_b: torch.Tensor
    att_v: torch.Tensor
    w_out: torch.Tensor
    b_out: torch.Tensor


def _rounder(compute_dtype: torch.dtype):
    """x -> x rounded to ``compute_dtype`` and back to f32 (a product of
    two bf16 values is exact in f32, so rounding the operands and
    multiplying in f32 is the bf16 product with f32 accumulation)."""
    if compute_dtype == torch.float32:
        return lambda x: x.float()
    return lambda x: x.to(compute_dtype).float()


def _mask(enc_len: torch.Tensor, T: int) -> torch.Tensor:
    return (torch.arange(T, device=enc_len.device)[None, :]
            < enc_len[:, None]).float()


def init_state(batch: int, enc_frames: int, hidden: int, enc_dim: int,
               device) -> Dict[str, torch.Tensor]:
    """The JAX ``init_state`` of one decoder layer: zeros."""
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return {"h": z(1, batch, hidden), "c": z(1, batch, hidden),
            "att_w": z(batch, enc_frames), "context": z(batch, enc_dim)}


def decoder_step(w: Weights, state, token, enc, enc_proj, enc_mask,
                 compute_dtype: torch.dtype = torch.float32,
                 att_kind: str = "dot"):
    """One decode step (one layer). token [B] -> (new_state, logits
    [B,V]); the JAX ``AttentionDecoder.step`` with the fused kernel's
    arithmetic."""
    r = _rounder(compute_dtype)
    H = w.w_h.shape[0]
    A = w.att_q.shape[1]
    emb = r(w.embed[token.long()])
    x = torch.cat([emb, state["context"]], dim=-1)
    gates = (torch.matmul(r(x), r(w.w_x)) + w.b_x
             + torch.matmul(r(state["h"][0]), r(w.w_h)))
    gi, gf, gg, go = torch.split(gates, H, dim=-1)
    c = torch.sigmoid(gf + 1.0) * state["c"][0] + torch.sigmoid(gi) * torch.tanh(gg)
    h = torch.sigmoid(go) * torch.tanh(c)
    qb = torch.matmul(r(h), r(w.att_q)) + w.att_b
    encp = r(enc_proj)
    if att_kind == "dot":
        scores = (encp * qb[:, None, :]).sum(-1) * float(
            torch.tensor(1.0 / math.sqrt(A), dtype=torch.float32))
    elif att_kind == "add":
        scores = (torch.tanh(encp + qb[:, None, :]) * w.att_v[:, 0]).sum(-1)
    else:
        raise ValueError(f"att_kind must be one of {ATT_KINDS}, got {att_kind!r}")
    scores = torch.where(enc_mask > 0, scores, NEG)
    p = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
    att = p / p.sum(dim=-1, keepdim=True) * enc_mask
    ctx = torch.bmm(r(att)[:, None, :], r(enc))[:, 0]
    logits = torch.matmul(r(torch.cat([h, ctx], dim=-1)), r(w.w_out)) + w.b_out
    return {"h": h[None], "c": c[None], "att_w": att, "context": ctx}, logits


def las_decoder_fwd_plain(tokens, coins, enc, enc_proj, enc_len, w: Weights,
                          compute_dtype: torch.dtype = torch.float32,
                          att_kind: str = "dot"):
    """tokens [B,L] int (gold inputs; [:,0] is sos), coins [B,L] bool
    (feed the previous step's argmax), enc [B,T,D], enc_proj [B,T,A],
    enc_len [B]. Returns (logits [B,L,V] f32, (h_seq, c_seq, att_seq,
    ctx_seq, tok_seq)), the residuals of the TPU forward kernel."""
    las_decoder_fwd_plain.calls += 1
    B, L = tokens.shape
    T, D = enc.shape[1], enc.shape[2]
    H = w.w_h.shape[0]
    mask = _mask(enc_len, T)
    state = init_state(B, T, H, D, enc.device)
    pred = torch.zeros(B, dtype=tokens.dtype, device=tokens.device)
    outs = {k: [] for k in ("logits", "h", "c", "att", "ctx", "tok")}
    for i in range(L):
        tok = torch.where(coins[:, i].bool(), pred, tokens[:, i])
        state, logits = decoder_step(w, state, tok, enc, enc_proj, mask,
                                     compute_dtype, att_kind)
        pred = torch.argmax(logits, dim=-1).to(tokens.dtype)
        for k, v in (("logits", logits), ("h", state["h"][0]),
                     ("c", state["c"][0]), ("att", state["att_w"]),
                     ("ctx", state["context"]), ("tok", tok)):
            outs[k].append(v)
    seq = {k: torch.stack(v, dim=1) for k, v in outs.items()}
    return seq["logits"], (seq["h"], seq["c"], seq["att"], seq["ctx"],
                           seq["tok"])


las_decoder_fwd_plain.calls = 0


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """x[:, i] -> x[:, i-1], zeros at i = 0 (the previous step's state)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def las_decoder_bwd_plain(dlogits, resid, enc, enc_proj, enc_len, w: Weights,
                          compute_dtype: torch.dtype = torch.float32,
                          att_kind: str = "dot"):
    """The reverse sweep of the TPU backward kernel
    (``pallas_decoder.py:510-664``), the gates recomputed from the
    residuals. dlogits [B,L,V]. Returns the per-step streams dgates
    [B,L,4H] (i,f,g,o), dctx [B,L,D], dqb [B,L,A], demb [B,L,E], the
    accumulated d_enc_proj [B,T,A], and d_att_v [A,1] (None for dot)."""
    las_decoder_bwd_plain.calls += 1
    h_seq, c_seq, att_seq, ctx_seq, tok_seq = resid
    B, L, _ = dlogits.shape
    T, D = enc.shape[1], enc.shape[2]
    H, E, A = w.w_h.shape[0], w.embed.shape[1], w.att_q.shape[1]
    r = _rounder(compute_dtype)
    mask = _mask(enc_len, T)
    enc_r, encp_r = r(enc), r(enc_proj)
    w_out_r, att_q_r, w_x_r, w_h_r = r(w.w_out), r(w.att_q), r(w.w_x), r(w.w_h)
    h_prev, c_prev, ctx_prev = (_shift_right(s) for s in (h_seq, c_seq, ctx_seq))
    f32 = dict(device=enc.device, dtype=torch.float32)
    dh = torch.zeros(B, H, **f32)
    dc = torch.zeros(B, H, **f32)
    dctx_c = torch.zeros(B, D, **f32)
    d_encp = torch.zeros(B, T, A, **f32)
    d_v = torch.zeros(A, **f32)
    dgates = torch.empty(B, L, 4 * H, **f32)
    dctx = torch.empty(B, L, D, **f32)
    dqb = torch.empty(B, L, A, **f32)
    demb = torch.empty(B, L, E, **f32)
    scale = float(torch.tensor(1.0 / math.sqrt(A), dtype=torch.float32))
    for i in range(L - 1, -1, -1):
        # output head: d[h; ctx] = dlogits . W_out^T
        dhc = torch.matmul(r(dlogits[:, i]), w_out_r.T)
        dh_tot = dh + dhc[:, :H]
        dctx_tot = dctx_c + dhc[:, H:]
        dctx[:, i] = dctx_tot
        # context -> attention weights -> softmax backward
        datt = torch.bmm(r(dctx_tot)[:, None, :], enc_r.transpose(1, 2))[:, 0]
        alpha = att_seq[:, i]
        dsm = datt * mask
        ds = alpha * (dsm - (dsm * alpha).sum(-1, keepdim=True))
        qb = torch.matmul(r(h_seq[:, i]), att_q_r) + w.att_b
        if att_kind == "dot":
            dsn = ds * scale
            dq = (encp_r * dsn[..., None]).sum(1)
            d_encp += dsn[..., None] * qb[:, None, :]
        else:
            th = torch.tanh(encp_r + qb[:, None, :])
            d_v += (th * ds[..., None]).sum((0, 1))
            de = (1.0 - th * th) * ds[..., None] * w.att_v[:, 0]
            d_encp += de
            dq = de.sum(1)
        dqb[:, i] = dq
        dh_tot = dh_tot + torch.matmul(r(dq), att_q_r.T)
        # LSTM cell, gates recomputed
        x = torch.cat([r(w.embed[tok_seq[:, i].long()]), ctx_prev[:, i]], -1)
        gates = (torch.matmul(r(x), w_x_r) + w.b_x
                 + torch.matmul(r(h_prev[:, i]), w_h_r))
        gi, gf, gg, go = torch.split(gates, H, dim=-1)
        si, sf = torch.sigmoid(gi), torch.sigmoid(gf + 1.0)
        tg, so = torch.tanh(gg), torch.sigmoid(go)
        tanh_c = torch.tanh(c_seq[:, i])
        d_o = dh_tot * tanh_c
        dc_tot = dh_tot * so * (1.0 - tanh_c * tanh_c) + dc
        dg = torch.cat([dc_tot * tg * si * (1.0 - si),
                        dc_tot * c_prev[:, i] * sf * (1.0 - sf),
                        dc_tot * si * (1.0 - tg * tg),
                        d_o * so * (1.0 - so)], dim=-1)
        dgates[:, i] = dg
        dh = torch.matmul(r(dg), w_h_r.T)
        dc = dc_tot * sf
        dx = torch.matmul(r(dg), w_x_r.T)
        demb[:, i] = dx[:, :E]
        dctx_c = dx[:, E:]
    return {"dgates": dgates, "dctx": dctx, "dqb": dqb, "demb": demb,
            "d_encp": d_encp,
            "d_att_v": d_v[:, None] if att_kind == "add" else None}


las_decoder_bwd_plain.calls = 0


def weight_grads(streams, resid, dlogits, w: Weights) -> Dict[str, torch.Tensor]:
    """The gradients the JAX package forms outside its backward kernel
    (``pallas_decoder.py:856-869``), from the kernel's per-step streams:
    one product (or scatter) each, in f32."""
    h_seq, _, att_seq, ctx_seq, tok_seq = resid
    dgates, dqb = streams["dgates"], streams["dqb"]
    H4, A, V = dgates.shape[-1], dqb.shape[-1], dlogits.shape[-1]
    E = w.embed.shape[1]
    flat = lambda x: x.reshape(-1, x.shape[-1])  # noqa: E731
    x_seq = torch.cat([w.embed[tok_seq.long()].float(), _shift_right(ctx_seq)], -1)
    return {
        "w_x": flat(x_seq).T @ flat(dgates),
        "b_x": dgates.reshape(-1, H4).sum(0),
        "w_h": flat(_shift_right(h_seq)).T @ flat(dgates),
        "att_q": flat(h_seq).T @ flat(dqb),
        "att_b": dqb.reshape(-1, A).sum(0),
        "w_out": flat(torch.cat([h_seq, ctx_seq], -1)).T @ flat(dlogits),
        "b_out": dlogits.reshape(-1, V).sum(0),
        "embed": torch.zeros_like(w.embed, dtype=torch.float32).index_add_(
            0, tok_seq.reshape(-1).long(), streams["demb"].reshape(-1, E)),
        "enc": torch.bmm(att_seq.transpose(1, 2), streams["dctx"]),
    }


# ---------------------------------------------------------------------------
# The kernels (csrc/las_decoder.cu)
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("las_decoder")
    if lib.las_decoder_fwd.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        lib.las_decoder_fwd.argtypes = [ctypes.c_void_p] * 20 \
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p]
        lib.las_decoder_fwd.restype = ctypes.c_int
        lib.las_decoder_bwd.argtypes = [ctypes.c_void_p] * 17 \
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p]
        lib.las_decoder_bwd.restype = ctypes.c_int
        lib.las_decoder_error_string.argtypes = [ctypes.c_int]
        lib.las_decoder_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_args(tokens, coins, enc, enc_proj, enc_len, w: Weights,
                       compute_dtype, att_kind, who: str):
    """(B, L, T, D, A, E, H, V) of a call the kernels can take; raises
    otherwise."""
    if enc.device.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {enc.device}")
    if att_kind != "dot":
        raise NotImplementedError(
            f"att_type={att_kind!r} on the card: K4's add and loc modes are "
            "not ported to CUDA yet, only dot attention (ROADMAP.md)")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")
    B, L = tokens.shape
    _, T, D = enc.shape
    H, E, A = w.w_h.shape[0], w.embed.shape[1], w.att_q.shape[1]
    V = w.embed.shape[0]
    if not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"hidden size {H} outside the kernel's 1..{MAX_HIDDEN}")
    dev = enc.device
    want = {"coins": (coins, (B, L)), "enc_proj": (enc_proj, (B, T, A)),
            "enc_len": (enc_len, (B,)), "w_x": (w.w_x, (E + D, 4 * H)),
            "b_x": (w.b_x, (4 * H,)), "w_h": (w.w_h, (H, 4 * H)),
            "att_b": (w.att_b, (A,)), "w_out": (w.w_out, (H + D, V)),
            "b_out": (w.b_out, (V,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    return B, L, T, D, A, E, H, V


def _operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor at a 16-byte aligned address
    (the kernels read weight rows as vectors)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launched(lib, rc: int, what: str, dims) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.las_decoder_error_string(rc).decode()} "
                           f"(B,L,T,D,A,E,H,V = {dims})")


def _scale(A: int) -> float:
    return float(torch.tensor(1.0 / math.sqrt(A), dtype=torch.float32))


def las_decoder_fwd_kernel(tokens, coins, enc, enc_proj, enc_len, w: Weights,
                           compute_dtype: torch.dtype = torch.float32,
                           att_kind: str = "dot"):
    """K4-fwd on the card. The contract of ``las_decoder_fwd_plain``,
    plus what K4-bwd reads instead of recomputing: (acts [B,L,4H], the
    gate activations sig(i), sig(f+1), tanh(g), sig(o) in w_x's column
    layout; q_seq [B,L,A], the attention query)."""
    dims = _check_kernel_args(tokens, coins, enc, enc_proj, enc_len, w,
                              compute_dtype, att_kind, "las_decoder_fwd_kernel")
    B, L, T, D, A, E, H, V = dims
    dev, cd = enc.device, compute_dtype
    f32 = dict(device=dev, dtype=torch.float32)
    logits = torch.empty(B, L, V, **f32)
    h_seq, c_seq = torch.empty(B, L, H, **f32), torch.empty(B, L, H, **f32)
    acts, q_seq = torch.empty(B, L, 4 * H, **f32), torch.empty(B, L, A, **f32)
    att_seq, ctx_seq = torch.empty(B, L, T, **f32), torch.empty(B, L, D, **f32)
    tok_seq = torch.empty(B, L, dtype=torch.int32, device=dev)
    resid = (h_seq, c_seq, att_seq, ctx_seq, tok_seq)
    if B == 0 or L == 0:
        return logits, resid, (acts, q_seq)
    # The operands of the products go in the compute dtype, as the TPU
    # wrapper casts them; W_x and W_h stacked into one [E+D+H, 4H] matrix
    # for the gate product over [emb; ctx; h].
    f32 = torch.float32
    ops = [_operand(tokens, torch.int32), _operand(coins, torch.uint8),
           _operand(enc_len, torch.int32), _operand(enc, cd),
           _operand(enc_proj, cd), _operand(w.embed, cd),
           _operand(torch.cat([w.w_x, w.w_h], 0), cd), _operand(w.b_x, f32),
           _operand(w.att_q, cd), _operand(w.att_b, f32),
           _operand(w.w_out, cd), _operand(w.b_out, f32)]
    outs = [logits, h_seq, c_seq, acts, q_seq, att_seq, ctx_seq, tok_seq]
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.las_decoder_fwd(
            *(t.data_ptr() for t in ops + outs), B, L, T, D, A, E, H, V,
            _scale(A), int(cd == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _launched(lib, rc, "las_decoder_fwd", dims)
    las_decoder_fwd_kernel.launches += 1
    return logits, resid, (acts, q_seq)


las_decoder_fwd_kernel.launches = 0


def las_decoder_bwd_kernel(dlogits, resid, extras, enc, enc_proj, enc_len,
                           w: Weights, compute_dtype: torch.dtype = torch.float32,
                           att_kind: str = "dot"):
    """K4-bwd on the card: the reverse sweep from K4-fwd's residuals and
    saved activations (``extras``), and the d_enc_proj accumulation.
    Returns what ``las_decoder_bwd_plain`` returns."""
    h_seq, c_seq, att_seq, ctx_seq, tok_seq = resid
    acts, q_seq = extras
    dims = _check_kernel_args(tok_seq, tok_seq, enc, enc_proj, enc_len, w,
                              compute_dtype, att_kind, "las_decoder_bwd_kernel")
    B, L, T, D, A, E, H, V = dims
    dev, cd = enc.device, compute_dtype
    if dlogits.shape != (B, L, V) or dlogits.device != dev:
        raise ValueError(f"dlogits must be {(B, L, V)} on {dev}, got "
                         f"{tuple(dlogits.shape)} on {dlogits.device}")
    f32 = dict(device=dev, dtype=torch.float32)
    out = {"dgates": torch.empty(B, L, 4 * H, **f32),
           "dctx": torch.empty(B, L, D, **f32),
           "dqb": torch.empty(B, L, A, **f32),
           "demb": torch.empty(B, L, E, **f32),
           "d_encp": torch.empty(B, T, A, **f32), "d_att_v": None}
    if B == 0 or L == 0:
        out["d_encp"].zero_()
        return out
    dsn = torch.empty(B, L, T, **f32)  # scratch: the scaled score gradient
    # The transposed weights, so that each output column's weights lie
    # along the threads that own neighbouring columns (see the .cu).
    f32 = torch.float32
    ops = [_operand(dlogits, f32), _operand(enc_len, torch.int32),
           _operand(enc, cd), _operand(enc_proj, cd), _operand(w.w_out.T, cd),
           _operand(w.att_q.T, cd), _operand(torch.cat([w.w_x, w.w_h], 0).T, cd),
           _operand(c_seq, f32), _operand(acts, f32), _operand(att_seq, f32),
           _operand(q_seq, f32)]
    outs = [out["dgates"], out["dctx"], out["dqb"], out["demb"], dsn,
            out["d_encp"]]
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.las_decoder_bwd(
            *(t.data_ptr() for t in ops + outs), B, L, T, D, A, E, H, V,
            _scale(A), int(cd == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    _launched(lib, rc, "las_decoder_bwd", dims)
    las_decoder_bwd_kernel.launches += 1
    return out


las_decoder_bwd_kernel.launches = 0


def _route(t: torch.Tensor) -> str:
    """"plain" for a CPU tensor, "kernel" for a CUDA tensor."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise ValueError(f"las_decoder: no implementation for device {t.device}")


class LASDecoderFused(torch.autograd.Function):
    """``las_decoder`` with its gradient: the plain forward and backward
    for CPU tensors, K4-fwd and K4-bwd for CUDA tensors. Gradients for
    enc, enc_proj and every weight; none for the tokens, coins and
    lengths."""

    @staticmethod
    def forward(ctx, tokens, coins, enc, enc_proj, enc_len, compute_dtype,
                att_kind, *weights):
        w = Weights(*weights)
        args = (tokens, coins, enc, enc_proj, enc_len, w, compute_dtype,
                att_kind)
        if _route(enc) == "plain":
            (logits, resid), extras = las_decoder_fwd_plain(*args), (None, None)
        else:
            logits, resid, extras = las_decoder_fwd_kernel(*args)
        ctx.save_for_backward(enc, enc_proj, enc_len, *resid, *extras, *weights)
        ctx.compute_dtype, ctx.att_kind = compute_dtype, att_kind
        return logits

    @staticmethod
    def backward(ctx, dlogits):
        saved = ctx.saved_tensors
        enc, enc_proj, enc_len = saved[:3]
        resid, extras, w = saved[3:8], saved[8:10], Weights(*saved[10:])
        dlogits = dlogits.float().contiguous()
        args = (enc, enc_proj, enc_len, w, ctx.compute_dtype, ctx.att_kind)
        if _route(enc) == "plain":
            streams = las_decoder_bwd_plain(dlogits, resid, *args)
        else:
            streams = las_decoder_bwd_kernel(dlogits, resid, extras, *args)
        g = weight_grads(streams, resid, dlogits, w)
        grads = (g["embed"], g["w_x"], g["b_x"], g["w_h"], g["att_q"],
                 g["att_b"], streams["d_att_v"], g["w_out"], g["b_out"])
        return (None, None, g["enc"], streams["d_encp"], None, None, None,
                *(gr if t.requires_grad else None
                  for gr, t in zip(grads, w)))


def las_decoder(tokens, coins, enc, enc_proj, enc_len, w: Weights,
                compute_dtype: torch.dtype = torch.float32,
                att_kind: str = "dot") -> torch.Tensor:
    """Logits [B,L,V] of the teacher-forced decoder: the plain version for
    CPU tensors, the kernel for CUDA tensors; through ``LASDecoderFused``
    when a gradient is wanted."""
    if att_kind not in ATT_KINDS:
        raise ValueError(f"att_kind must be one of {ATT_KINDS}, got {att_kind!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (enc, enc_proj, *w)):
        return LASDecoderFused.apply(tokens, coins, enc, enc_proj, enc_len,
                                     compute_dtype, att_kind, *w)
    args = (tokens, coins, enc, enc_proj, enc_len, w, compute_dtype, att_kind)
    if _route(enc) == "plain":
        return las_decoder_fwd_plain(*args)[0]
    return las_decoder_fwd_kernel(*args)[0]
