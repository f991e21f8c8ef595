"""CTC operations: the loss with its analytic gradient (K2, K3), greedy
decoding and forced alignment (``ctc_viterbi_align``).

Counterpart of ``gluon_e2e_asr_tpu/ops/ctc.py`` and
``gluon_e2e_asr_tpu/ops/pallas_ctc.py``. The labels are expanded to the
blank-interleaved lattice of S = 2L+1 states; the alpha recursion (K2)
runs in the forward, and the backward runs the beta recursion fused with
the state posterior (K3), whose gradient with respect to the logits is
softmax(logits) - posterior. Each recursion has two versions:

- ``_alpha_plain`` / ``_beta_post_plain``: a torch loop over time with
  the TPU kernels' formulas. The CPU path, and the references the
  kernels are held against on the card.
- ``ctc_alpha_kernel`` / ``ctc_beta_post_kernel``: ``csrc/ctc.cu``,
  a row of S states on one block of W = ceil(S / (32 KMAX)) warps with
  the lattice states in registers, the warps' boundary states exchanged
  through shared memory with one barrier a step, table rows prefetched,
  the masks derived in the kernel; the wrapper launches the kernel and
  no other device operation.

``ctc_alpha`` and ``ctc_beta_post`` dispatch on the device (``_route``):
the plain version for a CPU tensor, the kernel for a CUDA tensor,
nothing else.
Rows with ``input_len`` 0 or an infeasible label sequence carry a loss
and a gradient of exactly 0 (like torch's ``zero_infinity``).
"""

from __future__ import annotations

import ctypes

import torch

from gluon_e2e_asr_tpu_torch import _build

NEG_INF = -1e30
MAX_STATES = 1024  # the kernels' largest lattice
# csrc/ctc.cu's CTC_KMAX (lattice states a lane at most) and CTC_DEPTH
# (steps prefetched): warp_plan mirrors its ctc_warp_plan.
KMAX = 2
DEPTH = 4
_MAX_SMEM = 232448  # a block's dynamic shared memory on sm_90


def _expand_labels(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """[B, L] -> blank-interleaved state labels [B, 2L+1]:
    (blank, l1, blank, l2, ..., lL, blank)."""
    B, L = labels.shape
    ext = torch.full((B, 2 * L + 1), blank_id, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _transition_mask(ext: torch.Tensor, blank_id: int) -> torch.Tensor:
    """allow_skip[b, s]: whether s-2 -> s is legal (lab(s) != blank and
    lab(s) != lab(s-2))."""
    lab_m2 = torch.nn.functional.pad(ext, (2, 0), value=blank_id)[:, :-2]
    return (ext != blank_id) & (ext != lab_m2)


def _gather_states(logp: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """[B,T,V] log-probs + [B,S] state labels -> [T,B,S] emissions (an
    exact gather; the JAX package's one-hot product gives the same values
    in f32)."""
    B, T, _ = logp.shape
    idx = ext.long()[:, None, :].expand(B, T, ext.shape[1])
    return torch.gather(logp, 2, idx).permute(1, 0, 2).contiguous()


def _feasible(input_lens, labels, label_lens):
    """A CTC alignment exists iff T >= L + (# adjacent repeated labels)."""
    L = labels.shape[1]
    pos = torch.arange(1, L, device=labels.device)[None, :]
    rep = (labels[:, 1:] == labels[:, :-1]) & (pos < label_lens[:, None])
    needed = label_lens + rep.sum(dim=1)
    return (input_lens > 0) & (input_lens >= needed)


def _logsumexp3(a0, a1, a2):
    m = torch.maximum(torch.maximum(a0, a1), a2)
    msafe = torch.clamp(m, min=NEG_INF)
    return msafe + torch.log(torch.exp(a0 - msafe) + torch.exp(a1 - msafe)
                             + torch.exp(a2 - msafe))


def _shift(a: torch.Tensor, n: int) -> torch.Tensor:
    """a[:, s] -> a[:, s-n] (n > 0) or a[:, s+|n|] (n < 0), NEG_INF filled."""
    if n > 0:
        return torch.nn.functional.pad(a, (n, 0), value=NEG_INF)[:, :-n]
    return torch.nn.functional.pad(a, (0, -n), value=NEG_INF)[:, -n:]


def _beta_inputs(time_mask, allow_skip, last_state):
    """skipf2, finalok [B,S] and is_last [T,B], as pallas_ctc.py computes
    them outside its kernel."""
    T, _ = time_mask.shape
    S = allow_skip.shape[1]
    skipf2 = torch.nn.functional.pad(allow_skip, (0, 2))[:, 2:]
    s_idx = torch.arange(S, device=allow_skip.device)[None, :]
    finalok = (s_idx == last_state[:, None]) | (s_idx == last_state[:, None] - 1)
    t_lens = time_mask.sum(dim=0)
    is_last = torch.arange(T, device=time_mask.device)[:, None] == (t_lens[None, :] - 1)
    return skipf2, finalok, is_last


def _alpha_plain(emit, time_mask, allow_skip, state_valid):
    """emit [T,B,S] f32, time_mask [T,B], allow_skip and state_valid
    [B,S] bool -> alpha [T,B,S] (log space)."""
    _alpha_plain.calls += 1
    T, B, S = emit.shape
    s_idx = torch.arange(S, device=emit.device)[None, :]
    first_ok = (s_idx <= 1) & state_valid
    a = torch.full((B, S), NEG_INF, device=emit.device, dtype=emit.dtype)
    a[:, 0] = 0.0
    out = []
    for t in range(T):
        if t == 0:
            new = torch.where(first_ok, emit[0], NEG_INF)
        else:
            a2 = torch.where(allow_skip, _shift(a, 2), NEG_INF)
            new = _logsumexp3(a, _shift(a, 1), a2) + emit[t]
            new = torch.where(state_valid, new, NEG_INF)
        a = torch.where(time_mask[t][:, None], new, a)
        out.append(a)
    return torch.stack(out)


_alpha_plain.calls = 0


def _beta_post_plain(emit, time_mask, allow_skip, state_valid, last_state,
                     alpha, ll):
    """The beta recursion fused with the state posterior: post [T,B,S] =
    exp(clip(alpha + beta - emit - ll, 2*NEG_INF, 0)), 0 on invalid
    states and past each row's length."""
    _beta_post_plain.calls += 1
    T, B, S = emit.shape
    skipf2, finalok, is_last = _beta_inputs(time_mask, allow_skip, last_state)
    b = torch.full((B, S), NEG_INF, device=emit.device, dtype=emit.dtype)
    post = torch.empty_like(emit)
    for t in range(T - 1, -1, -1):
        b2 = torch.where(skipf2, _shift(b, -2), NEG_INF)
        new = emit[t] + _logsumexp3(b, _shift(b, -1), b2)
        new = torch.where(is_last[t][:, None],
                          torch.where(finalok, emit[t], NEG_INF), new)
        new = torch.where(state_valid, new, NEG_INF)
        tm = time_mask[t][:, None]
        b = torch.where(tm, new, b)
        gamma = alpha[t] + b - emit[t]
        p = torch.exp(torch.clamp(gamma - ll[:, None], 2 * NEG_INF, 0.0))
        post[t] = torch.where(state_valid & tm, p, 0.0)
    return post


_beta_post_plain.calls = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("ctc")
    if lib.ctc_alpha.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        ints = [ctypes.c_int] * 5
        lib.ctc_alpha.argtypes = [ctypes.c_void_p] * 5 + ints + [ctypes.c_void_p]
        lib.ctc_alpha.restype = ctypes.c_int
        lib.ctc_beta_post.argtypes = [ctypes.c_void_p] * 8 + ints \
            + [ctypes.c_void_p]
        lib.ctc_beta_post.restype = ctypes.c_int
        lib.ctc_plan.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.ctc_plan.restype = ctypes.c_int
        lib.ctc_error_string.argtypes = [ctypes.c_int]
        lib.ctc_error_string.restype = ctypes.c_char_p
    return lib


def warp_plan(T: int, S: int):
    """(k, W, smem): the kernels' launch for a [T,B,S] lattice, one block
    a batch row, as ``csrc/ctc.cu::ctc_warp_plan`` picks it by shape
    alone: k lattice states a lane, W warps a row, and the block's dynamic
    shared memory in bytes (the boundary slots, 16 W; the prefetch ring,
    two tables' rows of DEPTH + 1 steps, 32 W k floats each; and the
    time-mask column, T padded to 16)."""
    W = -(-S // (32 * KMAX))
    k = -(-S // (32 * W))
    smem = 16 * W + 2 * (DEPTH + 1) * 128 * W * k + -(-T // 16) * 16
    return k, W, smem


def _kernel_shape(emit: torch.Tensor, who: str):
    if emit.device.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {emit.device}")
    if emit.dim() != 3 or emit.dtype != torch.float32:
        raise ValueError(f"emit must be [T,B,S] float32, got "
                         f"{tuple(emit.shape)} {emit.dtype}")
    T, B, S = emit.shape
    if S > MAX_STATES:
        raise ValueError(f"{S} lattice states exceed the kernel's "
                         f"{MAX_STATES}")
    return T, B, S


def _mask(t: torch.Tensor, shape, dev) -> torch.Tensor:
    """A bool (or uint8) mask as the kernels' uint8 bytes: a view of the
    same storage, no copy."""
    if tuple(t.shape) != tuple(shape) or t.device != dev:
        raise ValueError(f"mask of shape {tuple(t.shape)} on {t.device}, "
                         f"expected {tuple(shape)} on {dev}")
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    elif t.dtype != torch.uint8:
        raise ValueError(f"masks are bool or uint8, got {t.dtype}")
    return t.contiguous()


def _alpha_args(emit, time_mask, allow_skip, state_valid):
    """K2's operands in the C entry's order: emit, time_mask [T,B],
    allow_skip, state_valid [B,S] (masks as uint8 views)."""
    T, B, S = emit.shape
    dev = emit.device
    return (emit.contiguous(), _mask(time_mask, (T, B), dev),
            _mask(allow_skip, (B, S), dev), _mask(state_valid, (B, S), dev))


def _beta_args(emit, time_mask, allow_skip, state_valid, last_state, alpha,
               ll):
    """K3's operands in the C entry's order: K2's, then last_state [B]
    int32, alpha [T,B,S] and ll [B] f32 (each as it is where it already
    has that type and layout)."""
    T, B, S = emit.shape
    if (tuple(alpha.shape) != (T, B, S) or tuple(ll.shape) != (B,)
            or tuple(last_state.shape) != (B,)):
        raise ValueError(f"alpha {tuple(alpha.shape)} / ll {tuple(ll.shape)} "
                         f"/ last_state {tuple(last_state.shape)} do not "
                         f"match emit {tuple(emit.shape)}")
    dev = emit.device
    if alpha.device != dev or ll.device != dev or last_state.device != dev:
        raise ValueError(f"alpha, ll and last_state must be on {dev}")
    return (*_alpha_args(emit, time_mask, allow_skip, state_valid),
            last_state.to(torch.int32).contiguous(),
            alpha.to(torch.float32).contiguous(),
            ll.to(torch.float32).contiguous())


def _launch(entry: str, ops, out, T, B, S) -> None:
    k, W, smem = warp_plan(T, S)
    if smem > _MAX_SMEM:
        raise ValueError(f"ctc: the plan's {smem} bytes of shared memory "
                         f"(T={T}, S={S}) do not fit a block")
    lib = _lib()
    dev = out.device
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            *(o.data_ptr() for o in ops), out.data_ptr(), T, B, S, k, W,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.ctc_error_string(rc).decode()} "
                           f"(T={T} B={B} S={S}, plan k={k} W={W})")


def ctc_alpha_kernel(emit, time_mask, allow_skip, state_valid):
    """K2 on the card; the contract of ``_alpha_plain``."""
    T, B, S = _kernel_shape(emit, "ctc_alpha_kernel")
    ops = _alpha_args(emit, time_mask, allow_skip, state_valid)
    alpha = torch.empty_like(ops[0])
    if T == 0 or B == 0 or S == 0:
        return alpha
    _launch("ctc_alpha", ops, alpha, T, B, S)
    ctc_alpha_kernel.launches += 1
    return alpha


ctc_alpha_kernel.launches = 0


def ctc_beta_post_kernel(emit, time_mask, allow_skip, state_valid,
                         last_state, alpha, ll):
    """K3 on the card; the contract of ``_beta_post_plain``."""
    T, B, S = _kernel_shape(emit, "ctc_beta_post_kernel")
    ops = _beta_args(emit, time_mask, allow_skip, state_valid, last_state,
                     alpha, ll)
    post = torch.empty_like(ops[0])
    if T == 0 or B == 0 or S == 0:
        return post
    _launch("ctc_beta_post", ops, post, T, B, S)
    ctc_beta_post_kernel.launches += 1
    return post


ctc_beta_post_kernel.launches = 0


def _route(emit: torch.Tensor) -> str:
    """"plain" for a CPU tensor, "kernel" for a CUDA tensor."""
    if emit.device.type == "cpu":
        return "plain"
    if emit.device.type == "cuda":
        return "kernel"
    raise ValueError(f"ctc: no implementation for device {emit.device}")


def ctc_alpha(emit, time_mask, allow_skip, state_valid):
    fn = _alpha_plain if _route(emit) == "plain" else ctc_alpha_kernel
    return fn(emit, time_mask, allow_skip, state_valid)


def ctc_beta_post(emit, time_mask, allow_skip, state_valid, last_state,
                  alpha, ll):
    fn = _beta_post_plain if _route(emit) == "plain" else ctc_beta_post_kernel
    return fn(emit, time_mask, allow_skip, state_valid, last_state, alpha, ll)


def _lattice(T, input_lens, labels, label_lens, blank_id):
    """(ext, allow_skip, state_valid [B,S], time_mask [T,B])."""
    S = 2 * labels.shape[1] + 1
    ext = _expand_labels(labels, blank_id)
    allow_skip = _transition_mask(ext, blank_id)
    state_valid = (torch.arange(S, device=labels.device)[None, :]
                   < (2 * label_lens + 1)[:, None])
    time_mask = (torch.arange(T, device=labels.device)[:, None]
                 < input_lens[None, :])
    return ext, allow_skip, state_valid, time_mask


def _log_likelihood(alpha, label_lens):
    """log p(labels | x) [B] from the last alpha row (frozen at each
    row's last frame)."""
    a_last = alpha[-1]
    last = (2 * label_lens).long()
    aL = torch.gather(a_last, 1, last[:, None])[:, 0]
    aLm1 = torch.gather(a_last, 1, torch.clamp(last - 1, min=0)[:, None])[:, 0]
    aLm1 = torch.where(label_lens > 0, aLm1, NEG_INF)
    m = torch.maximum(aL, aLm1)
    return m + torch.log(torch.exp(aL - m) + torch.exp(aLm1 - m))


class CTCLoss(torch.autograd.Function):
    """Per-sample CTC negative log likelihood with the analytic gradient
    (softmax - posterior) of ``ops/ctc.py::_ctc_bwd`` in the JAX
    package."""

    @staticmethod
    def forward(ctx, logits, input_lens, labels, label_lens, blank_id):
        B, T, V = logits.shape
        logp = torch.log_softmax(logits.float(), dim=-1)
        ext, allow_skip, state_valid, time_mask = _lattice(
            T, input_lens, labels, label_lens, blank_id)
        emit = _gather_states(logp, ext)
        alpha = ctc_alpha(emit, time_mask, allow_skip, state_valid)
        ll = _log_likelihood(alpha, label_lens)
        ok = _feasible(input_lens, labels, label_lens)
        ctx.save_for_backward(logp, emit, alpha, ll, ok, ext, allow_skip,
                              state_valid, time_mask, label_lens)
        return torch.where(ok, -ll, 0.0)

    @staticmethod
    def backward(ctx, g):
        (logp, emit, alpha, ll, ok, ext, allow_skip, state_valid, time_mask,
         label_lens) = ctx.saved_tensors
        B, T, V = logp.shape
        post = ctc_beta_post(emit, time_mask, allow_skip, state_valid,
                             2 * label_lens, alpha, ll)  # [T,B,S]
        # States -> vocabulary: the JAX package's one-hot product (a
        # matmul sums in a fixed order; a scatter-add into the vocabulary
        # would add atomically on the card, in an order that varies)
        onehot = torch.nn.functional.one_hot(ext.long(), V).to(post.dtype)
        posterior = torch.einsum("tbs,bsv->btv", post, onehot)
        grad = (torch.exp(logp) - posterior) * time_mask.T[:, :, None]
        grad = torch.where(ok[:, None, None], grad * g[:, None, None], 0.0)
        return grad, None, None, None, None


def ctc_loss(logits, input_lens, labels, label_lens, blank_id: int = 0):
    """Per-sample CTC negative log likelihood [B] from raw logits
    [B, T, V]. Ragged time/label lengths are handled by masking; rows
    with input_len == 0 or an infeasible label sequence contribute
    exactly 0 loss and 0 gradient."""
    return CTCLoss.apply(logits, input_lens, labels, label_lens, blank_id)


def ctc_viterbi_align(logp, input_lens, labels, label_lens, blank_id: int = 0):
    """CTC forced alignment: the most likely frame -> lattice-state path.

    The loss's lattice (blank-interleaved states, S = 2L+1); the alpha
    recursion with max in place of logsumexp, recording each state's
    best predecessor (0 stay, 1 advance, 2 skip), then a backtrace from
    the last frame. The emissions come by an exact gather, and ties go to
    stay, then advance, then skip (``jnp.argmax``'s first maximum), both
    written out because the backtrace is tie-sensitive. Frames past
    ``input_lens`` are frozen. Plain torch on either device; the JAX
    package runs two ``lax.scan``s here, no Pallas kernel.

    Returns ``(states [B, T] int32, score [B])``: ``states[b, t]`` is the
    state at frame t (odd 2k+1 = token k, even = blank; -1 past
    ``input_lens[b]`` and on infeasible rows, whose score is NEG_INF);
    ``score`` is the log-probability of the best alignment. ``logp`` is
    log-softmaxed [B, T, V]."""
    B, T, _ = logp.shape
    S = 2 * labels.shape[1] + 1
    dev = logp.device
    labels, label_lens = labels.long(), label_lens.long()
    input_lens = input_lens.long()
    ext = _expand_labels(labels, blank_id)
    allow_skip = _transition_mask(ext, blank_id)
    s_idx = torch.arange(S, device=dev)
    state_valid = s_idx[None, :] < (2 * label_lens + 1)[:, None]
    time_mask = torch.arange(T, device=dev)[:, None] < input_lens[None, :]
    emit = _gather_states(logp, ext)  # [T,B,S]
    delta = torch.where((s_idx[None, :] <= 1) & state_valid, emit[0], NEG_INF)
    delta = torch.where(time_mask[0][:, None], delta, NEG_INF)
    choices = torch.zeros(T, B, S, dtype=torch.int8, device=dev)
    for t in range(1, T):
        best, choice = delta, torch.zeros_like(choices[t])
        for k, cand in ((1, _shift(delta, 1)),
                        (2, torch.where(allow_skip, _shift(delta, 2), NEG_INF))):
            better = cand > best  # a tie keeps the earlier choice
            best = torch.where(better, cand, best)
            choice = torch.where(better, k, choice)
        choices[t] = choice
        new = torch.where(state_valid, best + emit[t], NEG_INF)
        delta = torch.where(time_mask[t][:, None], new, delta)
    last = 2 * label_lens
    d_last = torch.gather(delta, 1, last[:, None])[:, 0]
    d_prev = torch.gather(delta, 1, torch.clamp(last - 1, min=0)[:, None])[:, 0]
    d_prev = torch.where(label_lens > 0, d_prev, NEG_INF)
    score = torch.maximum(d_last, d_prev)
    s_fin = torch.where(d_last >= d_prev, last, torch.clamp(last - 1, min=0))
    s = torch.zeros(B, dtype=torch.long, device=dev)
    states = torch.empty(T, B, dtype=torch.long, device=dev)
    for t in range(T - 1, -1, -1):
        s = torch.where(input_lens - 1 == t, s_fin, s)
        active = t < input_lens
        states[t] = torch.where(active, s, -1)
        ch = torch.gather(choices[t], 1, torch.clamp(s, min=0)[:, None])[:, 0]
        if t > 0:
            s = torch.where(active, s - ch.long(), s)
    ok = _feasible(input_lens, labels, label_lens) & (label_lens >= 0)
    states = torch.where(ok[:, None], states.T, -1)
    return states.to(torch.int32), torch.where(ok, score, NEG_INF)


def spans_from_states(states_row, tokens, sec_per_frame: float):
    """Host side: a Viterbi state row [T] (``ctc_viterbi_align``) -> per
    token {token, start_s, end_s}. Token k emits on state 2k+1; a token
    no frame occupies (absorbed by a skip) gets None."""
    import numpy as np

    states_row = np.asarray(states_row)
    spans = []
    for k, tok in enumerate(tokens):
        frames = np.nonzero(states_row == 2 * k + 1)[0]
        if len(frames) == 0:
            spans.append({"token": tok, "start_s": None, "end_s": None})
            continue
        spans.append({
            "token": tok,
            "start_s": round(float(frames[0]) * sec_per_frame, 4),
            "end_s": round(float(frames[-1] + 1) * sec_per_frame, 4),
        })
    return spans


def ctc_greedy_decode(logits: torch.Tensor, input_lens: torch.Tensor,
                      blank_id: int = 0):
    """Greedy CTC decode: framewise argmax (the first maximum, as JAX's);
    repeats and blanks are collapsed on the device. Returns (ids [B, T],
    lengths [B] int32) where each row holds the collapsed symbols
    left-justified, padded with blank."""
    B, T, _ = logits.shape
    best = torch.argmax(logits, dim=-1)  # [B,T]
    prev = torch.nn.functional.pad(best, (1, 0), value=blank_id)[:, :-1]
    t = torch.arange(T, device=logits.device)[None, :]
    keep = (best != blank_id) & (best != prev) & (t < input_lens[:, None])
    # Left-justify kept symbols: position = cumsum(keep) - 1. Dropped
    # symbols all go to T-1, which the length mask below clears unless
    # every frame was kept (and then none was dropped).
    pos = torch.cumsum(keep, dim=1) - 1
    out_len = keep.sum(dim=1).to(torch.int32)
    blank = torch.full_like(best, blank_id)
    out = blank.clone().scatter_(
        1, torch.where(keep, pos, torch.full_like(pos, T - 1)),
        torch.where(keep, best, blank))
    return torch.where(t < out_len[:, None], out, blank), out_len
