"""The teacher-forced LAS decoder over L steps: K4-fwd and K4-bwd.

Counterpart of ``gluon_e2e_asr_tpu/ops/pallas_decoder.py::
las_decoder_fused`` (forward ``las_decoder_fwd``, VJP
``las_decoder_bwd``). Each step: the embedding of the step's token (the
gold one, or the previous step's argmax where the scheduled-sampling
coin says so), one LSTM cell on [embedding; previous context], the
attention query, the attention scores (``dot``: scaled dot product;
``add``: v . tanh(enc_proj + q); ``loc``: as add, plus the location
feature of the previous step's attention weights projected by
``loc_proj``), the masked softmax over the encoder frames, the context,
and the output logits. Each direction has two versions:

- plain PyTorch: ``las_decoder_fwd_plain`` (a loop over
  ``decoder_step``, which ``models/decoder.py`` also uses for one step)
  and ``las_decoder_bwd_plain`` (an explicit reverse loop with the TPU
  backward kernel's formulas, not autograd). The CPU path, and the
  references the kernels are held against on the card. They compute
  the location feature as the TPU kernel does, as a product with the
  channel-major band (``build_loc_band_cmajor``).
- hand-written Hopper kernels: ``las_decoder_fwd_kernel`` and
  ``las_decoder_bwd_kernel`` (``csrc/las_decoder.cu``), every mode; the
  location feature is a convolution with the filter there. Each direction
  takes its cluster kernel, ``fwd_cluster_kernel`` or
  ``bwd_cluster_kernel`` (one batch row a CTA, the products split by
  columns across a cluster of ``CLUSTER_ROWS`` CTAs, their weights as
  ``_cluster_slices``), for every shape whose shared-memory plan fits,
  and ``fwd_kernel`` or ``bwd_kernel`` (two rows a block) for the
  others, chosen by shape alone (``fwd_route``, ``bwd_route``, the
  mirrors of the library's); ``.cluster_launches`` counts the former.

``las_decoder`` dispatches on the device of ``enc`` (``_route``): the
plain versions for a CPU tensor, the kernels for a CUDA tensor, and
nothing else; with gradients enabled it runs through ``LASDecoderFused``,
a ``torch.autograd.Function`` whose forward and backward dispatch the
same way. The weight gradients that the JAX package computes outside its
kernel as XLA einsums (``pallas_decoder.py:856-874``) are
``torch.matmul`` here, for both routes, the band's among them (the
embedding's a one-hot product, ``ops/onehot.py``: an ``index_add_``
would add atomically on the card, in an order that varies from run to
run); the filter's gradient comes from the band's by autograd
through ``build_loc_band_cmajor``, as JAX's does. The gradient of
``enc_proj`` is accumulated inside the kernels.

Precision (``pallas_decoder.py:30-35``): every product takes operands
rounded to ``compute_dtype`` and sums in f32; state, softmax, gate math,
the energies and their tanh stay f32. The dot-attention scores multiply
the rounded ``enc_proj`` by the f32 query, as the TPU kernel does; the
energies add the f32 query to the rounded ``enc_proj``. The location
feature is the product of the rounded previous attention weights with
the rounded band, kept in f32 and rounded again as the operand of
``loc_proj``. Gate order (i, f, g, o) with the forget bias +1 inside the
cell. The TPU's ``_T_CHUNK`` padding and VMEM admission
(``pick_block_batch``) have no counterpart: a shape the kernel cannot
take raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gluon_e2e_asr_tpu_torch import _build
from gluon_e2e_asr_tpu_torch.ops.onehot import embed, rows_sum

NEG = -1e30
ATT_KINDS = ("dot", "add", "loc")
MODES = {"dot": 0, "add": 1, "loc": 2}
MAX_HIDDEN = 1024
# The kernels' limits of the energy modes (csrc/las_decoder.cu): one
# thread per (row, attention column) of a block's two rows, the backward's
# energy lanes 4 columns at a time, and the location channels' sums in
# registers.
MAX_ATT_ENERGY = 512
ATT_ENERGY_MULTIPLE = 4
MAX_LOC_CHANNELS = 16
# K4's cluster kernels: CTAs (batch rows) of a cluster, threads of a
# block, and the 227 KB of shared memory a block may use.
CLUSTER_ROWS = 8
_THREADS = 1024
_MAX_SMEM = 232448


class Weights(NamedTuple):
    """The decoder's parameters in the JAX layouts: embed [V,E], w_x
    [E+D,4H], b_x [4H], w_h [H,4H], att_q [H,A], att_b [A], att_v [A,1]
    (zeros for dot attention), loc_proj [C,A] (zeros [1,A] unless loc),
    w_out [H+D,V], b_out [V]."""
    embed: torch.Tensor
    w_x: torch.Tensor
    b_x: torch.Tensor
    w_h: torch.Tensor
    att_q: torch.Tensor
    att_b: torch.Tensor
    att_v: torch.Tensor
    loc_proj: torch.Tensor
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


def build_loc_band_cmajor(loc_filter: torch.Tensor, T: int) -> torch.Tensor:
    """The location convolution as a matrix, channel-major: band [T,
    C*T] with band[s, c*T + t] = filter[s - t + (w-1)//2, 0, c] (zero off
    the band). Counterpart of ``pallas_decoder.py::build_loc_band_cmajor``;
    differentiable in ``loc_filter`` [w,1,C].

    Each channel's block is a Toeplitz matrix, built as the reversed
    windows of the zero-padded filter u (u[m] = filter[m - T + 1 +
    (w-1)//2], so block[s, t] = u[s - t + T - 1]): its gradient is then a
    sum over the windows (``unfold``'s backward), not a scatter of T*T*C
    entries onto w*C."""
    w, _, C = loc_filter.shape
    off = T - 1 - (w - 1) // 2
    u = F.pad(loc_filter[:, 0, :].T, (off, 2 * T - 1 - off - w))  # [C,2T-1]
    blocks = u.flip(-1).unfold(-1, T, 1).flip(1)  # [C,T(s),T(t)]
    return blocks.permute(1, 0, 2).reshape(T, C * T)


def band_feature(band: torch.Tensor, compute_dtype: torch.dtype
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """att_prev [N,T] -> the location feature [N,T,C] as the TPU kernel
    forms it: rounded weights times the rounded channel-major band, f32
    sums (``pallas_decoder.py:238-243``)."""
    r = _rounder(compute_dtype)
    band_r = r(band)
    T = band.shape[0]

    def feature(att_prev: torch.Tensor) -> torch.Tensor:
        f = torch.matmul(r(att_prev), band_r)
        return f.view(att_prev.shape[0], -1, T).transpose(1, 2)

    return feature


def init_state(batch: int, enc_frames: int, hidden: int, enc_dim: int,
               device, layers: int = 1) -> Dict[str, torch.Tensor]:
    """The JAX ``init_state``: zeros, h and c [layers, batch, hidden]."""
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return {"h": z(layers, batch, hidden), "c": z(layers, batch, hidden),
            "att_w": z(batch, enc_frames), "context": z(batch, enc_dim)}


def decoder_step(w: Weights, state, token, enc, enc_proj, enc_mask,
                 compute_dtype: torch.dtype = torch.float32,
                 att_kind: str = "dot",
                 loc_feature: Optional[Callable] = None,
                 beams: Optional[int] = None,
                 cells: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None):
    """One decode step. token [B] -> (new_state, logits [B,V]); the JAX
    ``AttentionDecoder.step`` with the fused kernel's arithmetic.
    ``cells``: the LSTM layers' (w_x, b_x, w_h), layer 0 taking
    [embedding; context] and layer l > 0 layer l-1's h (the state's h
    and c are [layers, B, H]); by default the one layer of ``w``.
    ``loc_feature`` maps the previous attention weights [N,T] to the
    location feature [N,T,C] (loc only). With ``beams`` = K the step is
    the JAX ``step_beam``: token, h, c and the context carry B*K rows,
    the attention weights [B,K,T], and the encoder tensors stay
    [B,T,*]."""
    r = _rounder(compute_dtype)
    H = w.w_h.shape[0]
    B, T = enc.shape[0], enc.shape[1]
    A = w.att_q.shape[1]
    K = beams or 1
    emb = r(embed(w.embed, token))
    x = torch.cat([emb, state["context"]], dim=-1)
    hs, cs = [], []
    for layer, (w_x, b_x, w_h) in enumerate(
            cells or ((w.w_x, w.b_x, w.w_h),)):
        gates = (torch.matmul(r(x), r(w_x)) + b_x
                 + torch.matmul(r(state["h"][layer]), r(w_h)))
        gi, gf, gg, go = torch.split(gates, H, dim=-1)
        c = (torch.sigmoid(gf + 1.0) * state["c"][layer]
             + torch.sigmoid(gi) * torch.tanh(gg))
        x = h = torch.sigmoid(go) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    qb = (torch.matmul(r(h), r(w.att_q)) + w.att_b).view(B, K, 1, A)
    encp = r(enc_proj)[:, None]  # [B,1,T,A]
    if att_kind == "dot":
        scores = (encp * qb).sum(-1) * float(
            torch.tensor(1.0 / math.sqrt(A), dtype=torch.float32))
    elif att_kind in ("add", "loc"):
        e = encp + qb
        if att_kind == "loc":
            f = loc_feature(state["att_w"].reshape(B * K, T))
            e = e + torch.matmul(r(f), r(w.loc_proj)).view(B, K, T, A)
        scores = (torch.tanh(e) * w.att_v[:, 0]).sum(-1)
    else:
        raise ValueError(f"att_kind must be one of {ATT_KINDS}, got {att_kind!r}")
    mask = enc_mask[:, None, :]
    scores = torch.where(mask > 0, scores, NEG)
    p = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
    att = p / p.sum(dim=-1, keepdim=True) * mask  # [B,K,T]
    ctx = torch.bmm(r(att), r(enc)).reshape(B * K, -1)
    logits = torch.matmul(r(torch.cat([h, ctx], dim=-1)), r(w.w_out)) + w.b_out
    return ({"h": torch.stack(hs), "c": torch.stack(cs),
             "att_w": att if beams else att[:, 0], "context": ctx}, logits)


def las_decoder_fwd_plain(tokens, coins, enc, enc_proj, enc_len, w: Weights,
                          compute_dtype: torch.dtype = torch.float32,
                          att_kind: str = "dot",
                          band: Optional[torch.Tensor] = None):
    """tokens [B,L] int (gold inputs; [:,0] is sos), coins [B,L] bool
    (feed the previous step's argmax), enc [B,T,D], enc_proj [B,T,A],
    enc_len [B], band [T,C*T] (loc only). Returns (logits [B,L,V] f32,
    (h_seq, c_seq, att_seq, ctx_seq, tok_seq)), the residuals of the TPU
    forward kernel."""
    las_decoder_fwd_plain.calls += 1
    B, L = tokens.shape
    T, D = enc.shape[1], enc.shape[2]
    H = w.w_h.shape[0]
    mask = _mask(enc_len, T)
    feature = band_feature(band, compute_dtype) if att_kind == "loc" else None
    state = init_state(B, T, H, D, enc.device)
    pred = torch.zeros(B, dtype=tokens.dtype, device=tokens.device)
    outs = {k: [] for k in ("logits", "h", "c", "att", "ctx", "tok")}
    for i in range(L):
        tok = torch.where(coins[:, i].bool(), pred, tokens[:, i])
        state, logits = decoder_step(w, state, tok, enc, enc_proj, mask,
                                     compute_dtype, att_kind, feature)
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
                          att_kind: str = "dot",
                          band: Optional[torch.Tensor] = None):
    """The reverse sweep of the TPU backward kernel
    (``pallas_decoder.py:510-664``), the gates recomputed from the
    residuals. dlogits [B,L,V]. Returns the per-step streams dgates
    [B,L,4H] (i,f,g,o), dctx [B,L,D], dqb [B,L,A], demb [B,L,E], the
    accumulated d_enc_proj [B,T,A], d_att_v [A,1] (None for dot), and in
    loc mode d_loc_proj [C,A] and the location feature's gradient dfct
    [B,L,C*T] (channel-major; None otherwise). In loc mode step i's
    scores depend on step i-1's attention weights, so the sweep carries
    dfct . band^T into the previous step's softmax backward."""
    las_decoder_bwd_plain.calls += 1
    h_seq, c_seq, att_seq, ctx_seq, tok_seq = resid
    B, L, _ = dlogits.shape
    T, D = enc.shape[1], enc.shape[2]
    H, E, A = w.w_h.shape[0], w.embed.shape[1], w.att_q.shape[1]
    is_loc = att_kind == "loc"
    r = _rounder(compute_dtype)
    mask = _mask(enc_len, T)
    enc_r, encp_r = r(enc), r(enc_proj)
    w_out_r, att_q_r, w_x_r, w_h_r = r(w.w_out), r(w.att_q), r(w.w_x), r(w.w_h)
    h_prev, c_prev, ctx_prev, att_prev = (
        _shift_right(s) for s in (h_seq, c_seq, ctx_seq, att_seq))
    f32 = dict(device=enc.device, dtype=torch.float32)
    dh = torch.zeros(B, H, **f32)
    dc = torch.zeros(B, H, **f32)
    dctx_c = torch.zeros(B, D, **f32)
    datt_c = torch.zeros(B, T, **f32)  # loc: d(previous attention weights)
    d_encp = torch.zeros(B, T, A, **f32)
    d_v = torch.zeros(A, **f32)
    dgates = torch.empty(B, L, 4 * H, **f32)
    dctx = torch.empty(B, L, D, **f32)
    dqb = torch.empty(B, L, A, **f32)
    demb = torch.empty(B, L, E, **f32)
    if is_loc:
        C = w.loc_proj.shape[0]
        feature = band_feature(band, compute_dtype)
        band_r, locp_r = r(band), r(w.loc_proj)
        d_locp = torch.zeros(C, A, **f32)
        dfct = torch.empty(B, L, C * T, **f32)
    scale = float(torch.tensor(1.0 / math.sqrt(A), dtype=torch.float32))
    for i in range(L - 1, -1, -1):
        # output head: d[h; ctx] = dlogits . W_out^T
        dhc = torch.matmul(r(dlogits[:, i]), w_out_r.T)
        dh_tot = dh + dhc[:, :H]
        dctx_tot = dctx_c + dhc[:, H:]
        dctx[:, i] = dctx_tot
        # context -> attention weights -> softmax backward
        datt = torch.bmm(r(dctx_tot)[:, None, :], enc_r.transpose(1, 2))[:, 0]
        if is_loc:
            datt = datt_c + datt
        alpha = att_seq[:, i]
        dsm = datt * mask
        ds = alpha * (dsm - (dsm * alpha).sum(-1, keepdim=True))
        qb = torch.matmul(r(h_seq[:, i]), att_q_r) + w.att_b
        if att_kind == "dot":
            dsn = ds * scale
            dq = (encp_r * dsn[..., None]).sum(1)
            d_encp += dsn[..., None] * qb[:, None, :]
        else:
            e = encp_r + qb[:, None, :]
            if is_loc:
                f_r = r(feature(att_prev[:, i]))  # [B,T,C]
                e = e + torch.matmul(f_r, locp_r)
            th = torch.tanh(e)
            d_v += (th * ds[..., None]).sum((0, 1))
            de = (1.0 - th * th) * ds[..., None] * w.att_v[:, 0]
            d_encp += de
            dq = de.sum(1)
            if is_loc:
                de_r = r(de)
                d_locp += torch.einsum("btc,bta->ca", f_r, de_r)
                dft = torch.matmul(de_r, locp_r.T)  # [B,T,C]
                dfct[:, i] = dft.transpose(1, 2).reshape(B, C * T)
                datt_c = torch.matmul(r(dfct[:, i]), band_r.T)
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
            "d_att_v": None if att_kind == "dot" else d_v[:, None],
            "d_loc_proj": d_locp if is_loc else None,
            "dfct": dfct if is_loc else None}


las_decoder_bwd_plain.calls = 0


def weight_grads(streams, resid, dlogits, w: Weights) -> Dict[str, torch.Tensor]:
    """The gradients the JAX package forms outside its backward kernel
    (``pallas_decoder.py:856-874``), from the kernel's per-step streams:
    one product each (the embedding's a one-hot product), in f32. In loc mode also the band's,
    d_band[s, k] = sum over (b, i) of att[b,i-1,s] dfct[b,i,k]."""
    h_seq, _, att_seq, ctx_seq, tok_seq = resid
    dgates, dqb = streams["dgates"], streams["dqb"]
    H4, A, V = dgates.shape[-1], dqb.shape[-1], dlogits.shape[-1]
    E = w.embed.shape[1]
    flat = lambda x: x.reshape(-1, x.shape[-1])  # noqa: E731
    x_seq = torch.cat([w.embed[tok_seq.long()].float(), _shift_right(ctx_seq)], -1)
    g = {
        "w_x": flat(x_seq).T @ flat(dgates),
        "b_x": dgates.reshape(-1, H4).sum(0),
        "w_h": flat(_shift_right(h_seq)).T @ flat(dgates),
        "att_q": flat(h_seq).T @ flat(dqb),
        "att_b": dqb.reshape(-1, A).sum(0),
        "w_out": flat(torch.cat([h_seq, ctx_seq], -1)).T @ flat(dlogits),
        "b_out": dlogits.reshape(-1, V).sum(0),
        "embed": rows_sum(tok_seq.reshape(-1), streams["demb"].reshape(-1, E),
                          w.embed.shape[0]),
        "enc": torch.bmm(att_seq.transpose(1, 2), streams["dctx"]),
    }
    if streams.get("dfct") is not None:
        g["band"] = flat(_shift_right(att_seq)).T @ flat(streams["dfct"])
    return g


# ---------------------------------------------------------------------------
# The kernels (csrc/las_decoder.cu)
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("las_decoder")
    if lib.las_decoder_fwd.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        # The pointers, then B..W, mode, scale, cd_bf16, route, stream.
        tail = [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
        for d in ("fwd", "bwd"):
            fn = getattr(lib, f"las_decoder_{d}")
            fn.argtypes = [ctypes.c_void_p] * 23 + tail
            fn.restype = ctypes.c_int
            route = getattr(lib, f"las_decoder_{d}_route")
            route.argtypes = [ctypes.c_int] * 10
            route.restype = ctypes.c_int
        lib.las_decoder_error_string.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.las_decoder_error_string.restype = ctypes.c_char_p
    return lib


def _gemv_splits(N: int, cols: int) -> int:
    """``csrc/las_decoder.cu::gemv_splits`` for a block of _THREADS."""
    return min(max(_THREADS // -(-N // cols), 1), 32)


def _align4(n: int) -> int:
    return (n + 3) & ~3


def _cluster_units(X: int) -> int:
    """Columns of X (H, D or E) one CTA of the cluster kernel owns: a
    multiple of 4; CLUSTER_ROWS of them cover X, the last ones padded."""
    return 4 * -(-X // (4 * CLUSTER_ROWS))


def _cluster_stride(K: int) -> int:
    """``csrc/las_decoder.cu::cl_stride``: a product input's half stride."""
    return K + (12 - K % 8) % 8


def _cluster_splits(G: int, K: int) -> int:
    """Depth splits of a cluster product of G column groups over K."""
    return max(1, min(_THREADS // 32 // -(-G // 16), K // 32))


def _fwd_rows_plan(mode, T, D, A, E, H, V, C, W, cols) -> int:
    """Floats of ``fwd_kernel``'s shared-memory plan (``FwdSmem``)."""
    rows = 2
    o = rows * (E + D + H) + rows * (H + D) + rows * (H + A + T + V)
    p = max(_gemv_splits(n, cols) * rows * n for n in (4 * H, A, V, D))
    o = _align4(o + p)
    loc = mode == "loc"
    for n in ((0 if mode == "dot" else A), C * A * loc, W * C * loc):
        o = _align4(o + n)
    return o + rows * C * T * loc


def _cluster_fwd_plan(mode, T, D, A, E, H, V, C, W, cols) -> int:
    """Floats of ``fwd_cluster_kernel``'s plan (``ClFwdSmem``)."""
    R = CLUSTER_ROWS
    HU, AU, KX = _cluster_units(H), _cluster_units(A), E + D + H
    o = _align4(2 * 8 * _cluster_stride(KX) + A) + R * HU
    o = _align4(_align4(_align4(o + H + D) + T) + V)
    p = max(_cluster_splits(HU, KX) * R * 4 * HU,
            _cluster_splits(AU // 4, H) * R * AU,
            _gemv_splits(D, cols) * D, _gemv_splits(V, cols) * V)
    o = _align4(o + p)
    loc = mode == "loc"
    for n in ((0 if mode == "dot" else A), C * A * loc, W * C * loc,
              (T + W + 3) * loc):
        o = _align4(o + n)
    return o + C * T * loc


def _route_by_plan(cluster_plan, rows_plan, att_kind, compute_dtype,
                   *shape) -> Optional[str]:
    """"cluster" where ``cluster_plan`` fits a block's shared memory, else
    "rows" where ``rows_plan`` fits, else None (the library's
    ``route_by_plan``)."""
    dims = (att_kind, *shape, 8 if compute_dtype == torch.bfloat16 else 4)
    if 4 * cluster_plan(*dims) <= _MAX_SMEM:
        return "cluster"
    if 4 * rows_plan(*dims) <= _MAX_SMEM:
        return "rows"
    return None


def fwd_route(att_kind: str, compute_dtype: torch.dtype, T, D, A, E, H, V,
              C=0, W=0) -> Optional[str]:
    """The K4-fwd kernel for a shape, by shape alone, as the library's
    ``fwd_route`` picks it: "cluster" (``fwd_cluster_kernel``), "rows"
    (``fwd_kernel``) or None."""
    return _route_by_plan(_cluster_fwd_plan, _fwd_rows_plan, att_kind,
                          compute_dtype, T, D, A, E, H, V, C, W)


def _rows_plan(mode, T, D, A, E, H, V, C, W, cols) -> int:
    """Floats of ``bwd_kernel``'s shared-memory plan (``BwdSmem``)."""
    rows = 2
    kv = max(V, A, 4 * H)
    o = rows * kv + rows * D + 3 * rows * H + rows * D + rows * T
    p = max(_gemv_splits(n, cols) * rows * n for n in (H + D, H, E + D + H, A))
    if mode != "dot":
        p = max(p, rows * 32 * (A + 4),
                rows * C * T if mode == "loc" else 0)
        o = _align4(o)
    o = _align4(o + p)
    loc = mode == "loc"
    for n in ((0 if mode == "dot" else A), (0 if mode == "dot" else rows * A),
              C * A * loc, W * C * loc, rows * T * loc, rows * C * T * loc,
              rows * C * T * loc, rows * T * loc):
        o = _align4(o + n)
    return o + C * A * loc


def _cluster_plan(mode, T, D, A, E, H, V, C, W, cols) -> int:
    """Floats of ``bwd_cluster_kernel``'s plan (``ClBwdSmem``)."""
    R = CLUSTER_ROWS
    HU, DU, EU = (_cluster_units(x) for x in (H, D, E))
    NH, NX = HU + DU, EU + DU + HU
    o = _align4(_align4(T) + 8 * (_cluster_stride(V) + _cluster_stride(A)
                                  + _cluster_stride(4 * H)) + D)
    o = _align4(o + 3 * R * HU + R * DU + 6 * R * HU + T)
    p = max(_cluster_splits(g, k) * R * 4 * g
            for g, k in ((NH // 4, V), (HU // 4, A), (NX // 4, 4 * H)))
    if mode == "dot":
        p = max(p, _gemv_splits(A, cols) * A)
    else:
        p = max(p, 64 * (A + 4),
                C * (2 * T + 2 * W + 4) if mode == "loc" else 0)
    o = _align4(o + p)
    loc = mode == "loc"
    for n in ((0 if mode == "dot" else A), (0 if mode == "dot" else A),
              C * A * loc, W * C * loc, (T + W + 3) * loc, C * T * loc,
              C * T * loc, T * loc):
        o = _align4(o + n)
    return o + C * A * loc


def bwd_route(att_kind: str, compute_dtype: torch.dtype, T, D, A, E, H, V,
              C=0, W=0) -> Optional[str]:
    """The K4-bwd kernel for a shape, by shape alone, as the library's
    ``bwd_route`` picks it: "cluster" (``bwd_cluster_kernel``), "rows"
    (``bwd_kernel``) or None."""
    return _route_by_plan(_cluster_plan, _rows_plan, att_kind,
                          compute_dtype, T, D, A, E, H, V, C, W)


def _cluster_slices(m: torch.Tensor, segments) -> torch.Tensor:
    """The CLUSTER_ROWS per-CTA slices of one product of the cluster
    kernels. ``m`` [N, K] holds output column n's weights in row n (the
    backward's W_out [H+D, V], att_q [H, A] and [W_x; W_h] [E+D+H, 4H];
    the forward's [W_x; W_h]^T [4H, E+D+H] and att_q^T [A, H]);
    ``segments`` are the (first row, width X) of its parts (h and ctx; h;
    emb, ctx and h; the gates i, f, g and o; the query). CTA
    r owns columns [r*U, r*U + U) of each part, U = _cluster_units(X), in
    the order of the parts: N_r columns. Returns [R, K, N_r]: slice r,
    depth k, column n holds m[row of CTA r's column n, k], 0 where that
    column is past its part. Device operations only: no copy from the
    host."""
    R = CLUSTER_ROWS
    parts = []
    for first, X in segments:
        U = _cluster_units(X)
        seg = F.pad(m[first:first + X], (0, 0, 0, R * U - X))  # [R*U, K]
        parts.append(seg.reshape(R, U, -1))
    return torch.cat(parts, 1).transpose(1, 2).contiguous()


def _check_kernel_args(tokens, coins, enc, enc_proj, enc_len, w: Weights,
                       compute_dtype, att_kind, loc_filter, who: str):
    """(B, L, T, D, A, E, H, V, C, W) of a call the kernels can take
    (C = W = 0 unless loc); raises otherwise."""
    if enc.device.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {enc.device}")
    if att_kind not in MODES:
        raise ValueError(f"att_kind must be one of {ATT_KINDS}, got {att_kind!r}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")
    B, L = tokens.shape
    _, T, D = enc.shape
    H, E, A = w.w_h.shape[0], w.embed.shape[1], w.att_q.shape[1]
    V = w.embed.shape[0]
    if not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"hidden size {H} outside the kernel's 1..{MAX_HIDDEN}")
    if att_kind != "dot" and (A > MAX_ATT_ENERGY
                              or A % ATT_ENERGY_MULTIPLE):
        raise ValueError(f"att_dim {A} not a multiple of "
                         f"{ATT_ENERGY_MULTIPLE} up to {MAX_ATT_ENERGY}, as "
                         f"the kernel takes for {att_kind} attention")
    dev = enc.device
    want = {"coins": (coins, (B, L)), "enc_proj": (enc_proj, (B, T, A)),
            "enc_len": (enc_len, (B,)), "w_x": (w.w_x, (E + D, 4 * H)),
            "b_x": (w.b_x, (4 * H,)), "w_h": (w.w_h, (H, 4 * H)),
            "att_b": (w.att_b, (A,)), "att_v": (w.att_v, (A, 1)),
            "w_out": (w.w_out, (H + D, V)), "b_out": (w.b_out, (V,))}
    C = W = 0
    if att_kind == "loc":
        if loc_filter is None or loc_filter.dim() != 3:
            raise ValueError("loc attention needs loc_filter [w,1,C]")
        W, C = loc_filter.shape[0], loc_filter.shape[2]
        if not 0 < C <= MAX_LOC_CHANNELS:
            raise ValueError(f"{C} location channels outside the kernel's "
                             f"1..{MAX_LOC_CHANNELS}")
        want["loc_filter"] = (loc_filter, (W, 1, C))
        want["loc_proj"] = (w.loc_proj, (C, A))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    return B, L, T, D, A, E, H, V, C, W


def _operand(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor at a 16-byte aligned address
    (the kernels read weight rows as vectors)."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _energy_operands(w: Weights, att_kind, loc_filter, cd):
    """att_v, the filter [W,C] and loc_proj [C,A] as the energy modes
    read them (f32; the products' operands rounded to ``cd``), or NULL
    pointers where the mode reads none."""
    if att_kind == "dot":
        return [None, None, None]
    r = _rounder(cd)
    f32 = torch.float32
    ops = [_operand(w.att_v[:, 0], f32)]
    if att_kind == "loc":
        ops += [_operand(r(loc_filter.detach()[:, 0, :]), f32),
                _operand(r(w.loc_proj.detach()), f32)]
    else:
        ops += [None, None]
    return ops


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launched(lib, rc: int, what: str, dims) -> None:
    if rc != 0:
        text = lib.las_decoder_error_string(rc, int(what == "las_decoder_fwd"))
        raise RuntimeError(f"{what} launch failed: {text.decode()} "
                           f"(B,L,T,D,A,E,H,V,C,W = {dims})")


def _scale(A: int) -> float:
    return float(torch.tensor(1.0 / math.sqrt(A), dtype=torch.float32))


def _count(fn, att_kind: str) -> None:
    fn.launches += 1
    fn.by_mode[att_kind] += 1


def las_decoder_fwd_kernel(tokens, coins, enc, enc_proj, enc_len, w: Weights,
                           compute_dtype: torch.dtype = torch.float32,
                           att_kind: str = "dot",
                           loc_filter: Optional[torch.Tensor] = None):
    """K4-fwd on the card. The contract of ``las_decoder_fwd_plain`` (loc
    mode takes the filter [w,1,C], not the band), plus what K4-bwd reads
    instead of recomputing: (acts [B,L,4H], the gate activations sig(i),
    sig(f+1), tanh(g), sig(o) in w_x's column layout; q_seq [B,L,A], the
    attention query with its bias). The kernel is ``fwd_route``'s for the
    shape, counted in ``.cluster_launches`` when it is
    ``fwd_cluster_kernel``; a shape no kernel's plan fits raises."""
    dims = _check_kernel_args(tokens, coins, enc, enc_proj, enc_len, w,
                              compute_dtype, att_kind, loc_filter,
                              "las_decoder_fwd_kernel")
    B, L, T, D, A, E, H, V, C, W = dims
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
    route = fwd_route(att_kind, cd, T, D, A, E, H, V, C, W)
    if route is None:
        raise ValueError(f"no K4-fwd kernel's shared memory holds the shape "
                         f"(B,L,T,D,A,E,H,V,C,W = {dims})")
    # The operands of the products go in the compute dtype, as the TPU
    # wrapper casts them; W_x and W_h stacked into one [E+D+H, 4H] matrix
    # for the gate product over [emb; ctx; h], sliced by the CTAs' gate
    # columns for the cluster kernel.
    wcat, att_q = torch.cat([w.w_x, w.w_h], 0), w.att_q
    if route == "cluster":
        wcat = _cluster_slices(wcat.T, tuple((j * H, H) for j in range(4)))
        att_q = _cluster_slices(att_q.T, ((0, A),))
    f32 = torch.float32
    ops = [_operand(tokens, torch.int32), _operand(coins, torch.uint8),
           _operand(enc_len, torch.int32), _operand(enc, cd),
           _operand(enc_proj, cd), _operand(w.embed, cd),
           _operand(wcat, cd), _operand(w.b_x, f32),
           _operand(att_q, cd), _operand(w.att_b, f32),
           *_energy_operands(w, att_kind, loc_filter, cd),
           _operand(w.w_out, cd), _operand(w.b_out, f32)]
    outs = [logits, h_seq, c_seq, acts, q_seq, att_seq, ctx_seq, tok_seq]
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.las_decoder_fwd(
            *(_ptr(t) for t in ops + outs), B, L, T, D, A, E, H, V, C, W,
            MODES[att_kind], _scale(A), int(cd == torch.bfloat16),
            int(route == "cluster"),
            torch.cuda.current_stream(dev).cuda_stream)
    _launched(lib, rc, "las_decoder_fwd", dims)
    _count(las_decoder_fwd_kernel, att_kind)
    las_decoder_fwd_kernel.cluster_launches += route == "cluster"
    return logits, resid, (acts, q_seq)


las_decoder_fwd_kernel.launches = 0
las_decoder_fwd_kernel.cluster_launches = 0
las_decoder_fwd_kernel.by_mode = dict.fromkeys(ATT_KINDS, 0)


def las_decoder_bwd_kernel(dlogits, resid, extras, enc, enc_proj, enc_len,
                           w: Weights, compute_dtype: torch.dtype = torch.float32,
                           att_kind: str = "dot",
                           loc_filter: Optional[torch.Tensor] = None):
    """K4-bwd on the card: the reverse sweep from K4-fwd's residuals and
    saved activations (``extras``), and the d_enc_proj accumulation.
    Returns what ``las_decoder_bwd_plain`` returns. d_att_v and d_loc_proj
    come from the kernel as partial sums (per batch row; ``bwd_kernel``'s
    d_loc_proj per block of rows, in its first row's slot), which this
    wrapper adds up (a fixed order: the same bits every run). The kernel
    is ``bwd_route``'s for the shape, counted in ``.cluster_launches``
    when it is ``bwd_cluster_kernel``; a shape no kernel's plan fits
    raises."""
    h_seq, c_seq, att_seq, ctx_seq, tok_seq = resid
    acts, q_seq = extras
    dims = _check_kernel_args(tok_seq, tok_seq, enc, enc_proj, enc_len, w,
                              compute_dtype, att_kind, loc_filter,
                              "las_decoder_bwd_kernel")
    B, L, T, D, A, E, H, V, C, W = dims
    dev, cd = enc.device, compute_dtype
    if dlogits.shape != (B, L, V) or dlogits.device != dev:
        raise ValueError(f"dlogits must be {(B, L, V)} on {dev}, got "
                         f"{tuple(dlogits.shape)} on {dlogits.device}")
    f32 = dict(device=dev, dtype=torch.float32)
    dot = att_kind == "dot"
    out = {"dgates": torch.empty(B, L, 4 * H, **f32),
           "dctx": torch.empty(B, L, D, **f32),
           "dqb": torch.empty(B, L, A, **f32),
           "demb": torch.empty(B, L, E, **f32),
           # Written whole by the dot mode; accumulated by the others.
           "d_encp": (torch.empty if dot else torch.zeros)(B, T, A, **f32),
           "d_att_v": None, "d_loc_proj": None, "dfct": None}
    dsn = dv_part = dlocp_part = None
    if dot:
        dsn = torch.empty(B, L, T, **f32)  # scratch: the scaled score gradient
    else:
        dv_part = torch.zeros(B, A, **f32)
    if att_kind == "loc":
        dlocp_part = torch.zeros(B, C, A, **f32)
        out["dfct"] = torch.zeros(B, L, C * T, **f32)
    if B == 0 or L == 0:
        out["d_encp"].zero_()
    else:
        route = bwd_route(att_kind, cd, T, D, A, E, H, V, C, W)
        if route is None:
            raise ValueError(f"no K4-bwd kernel's shared memory holds the "
                             f"shape (B,L,T,D,A,E,H,V,C,W = {dims})")
        wcat = torch.cat([w.w_x, w.w_h], 0)
        if route == "cluster":
            weights = (_cluster_slices(w.w_out, ((0, H), (H, D))),
                       _cluster_slices(w.att_q, ((0, H),)),
                       _cluster_slices(wcat, ((0, E), (E, D), (E + D, H))))
        else:
            # The transposed weights, so that each output column's weights
            # lie along the threads that own neighbouring columns.
            weights = (w.w_out.T, w.att_q.T, wcat.T)
        f32 = torch.float32
        ops = [_operand(dlogits, f32), _operand(enc_len, torch.int32),
               _operand(enc, cd), _operand(enc_proj, cd),
               *(_operand(t, cd) for t in weights),
               *_energy_operands(w, att_kind, loc_filter, cd),
               _operand(c_seq, f32), _operand(acts, f32),
               _operand(att_seq, f32), _operand(q_seq, f32)]
        outs = [out["dgates"], out["dctx"], out["dqb"], out["demb"], dsn,
                out["d_encp"], out["dfct"], dv_part, dlocp_part]
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.las_decoder_bwd(
                *(_ptr(t) for t in ops + outs), B, L, T, D, A, E, H, V, C, W,
                MODES[att_kind], _scale(A), int(cd == torch.bfloat16),
                int(route == "cluster"),
                torch.cuda.current_stream(dev).cuda_stream)
        _launched(lib, rc, "las_decoder_bwd", dims)
        _count(las_decoder_bwd_kernel, att_kind)
        las_decoder_bwd_kernel.cluster_launches += route == "cluster"
    if not dot:
        out["d_att_v"] = dv_part.sum(0)[:, None]
    if att_kind == "loc":
        out["d_loc_proj"] = dlocp_part.sum(0)
    return out


las_decoder_bwd_kernel.launches = 0
las_decoder_bwd_kernel.cluster_launches = 0
las_decoder_bwd_kernel.by_mode = dict.fromkeys(ATT_KINDS, 0)


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
    enc, enc_proj, the loc band and every weight; none for the tokens,
    coins, lengths and the filter (the kernels' copy of what the band is
    built from: its gradient comes through the band)."""

    @staticmethod
    def forward(ctx, tokens, coins, enc, enc_proj, enc_len, compute_dtype,
                att_kind, loc_filter, band, *weights):
        w = Weights(*weights)
        args = (tokens, coins, enc, enc_proj, enc_len, w, compute_dtype,
                att_kind)
        if _route(enc) == "plain":
            (logits, resid), extras = (las_decoder_fwd_plain(*args, band),
                                       (None, None))
        else:
            logits, resid, extras = las_decoder_fwd_kernel(*args, loc_filter)
        ctx.save_for_backward(enc, enc_proj, enc_len, loc_filter, band,
                              *resid, *extras, *weights)
        ctx.compute_dtype, ctx.att_kind = compute_dtype, att_kind
        return logits

    @staticmethod
    def backward(ctx, dlogits):
        saved = ctx.saved_tensors
        enc, enc_proj, enc_len, loc_filter, band = saved[:5]
        resid, extras, w = saved[5:10], saved[10:12], Weights(*saved[12:])
        dlogits = dlogits.float().contiguous()
        args = (enc, enc_proj, enc_len, w, ctx.compute_dtype, ctx.att_kind)
        if _route(enc) == "plain":
            streams = las_decoder_bwd_plain(dlogits, resid, *args, band)
        else:
            streams = las_decoder_bwd_kernel(dlogits, resid, extras, *args,
                                             loc_filter)
        g = weight_grads(streams, resid, dlogits, w)
        grads = (g["embed"], g["w_x"], g["b_x"], g["w_h"], g["att_q"],
                 g["att_b"], streams["d_att_v"], streams["d_loc_proj"],
                 g["w_out"], g["b_out"])
        return (None, None, g["enc"], streams["d_encp"], None, None, None,
                None, g.get("band"),
                *(gr if t.requires_grad else None
                  for gr, t in zip(grads, w)))


def las_decoder(tokens, coins, enc, enc_proj, enc_len, w: Weights,
                compute_dtype: torch.dtype = torch.float32,
                att_kind: str = "dot",
                loc_filter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits [B,L,V] of the teacher-forced decoder: the plain version for
    CPU tensors, the kernel for CUDA tensors; through ``LASDecoderFused``
    when a gradient is wanted. ``loc_filter`` [w,1,C]: the location
    filter (loc only), differentiable through the band built from it."""
    if att_kind not in ATT_KINDS:
        raise ValueError(f"att_kind must be one of {ATT_KINDS}, got {att_kind!r}")
    band = filt = None
    if att_kind == "loc":
        if loc_filter is None:
            raise ValueError("loc attention needs loc_filter")
        band = build_loc_band_cmajor(loc_filter, enc.shape[1])
        filt = loc_filter.detach()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (enc, enc_proj, *w)
            + ((band,) if band is not None else ())):
        return LASDecoderFused.apply(tokens, coins, enc, enc_proj, enc_len,
                                     compute_dtype, att_kind, filt, band, *w)
    args = (tokens, coins, enc, enc_proj, enc_len, w, compute_dtype, att_kind)
    if _route(enc) == "plain":
        return las_decoder_fwd_plain(*args, band)[0]
    return las_decoder_fwd_kernel(*args, filt)[0]
