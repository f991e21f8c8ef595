"""One BiLSTM layer with the input projection fused: K1-fwd and K1-bwd.

Counterpart of ``gluon_e2e_asr_tpu/ops/pallas_lstm.py::bilstm_fused``
(forward and VJP). Each direction of the computation has two versions:

- plain PyTorch: ``bilstm_fused_plain`` (a projection matmul and the
  time loop of ``models/lstm.py``) and ``bilstm_fused_bwd_plain`` (an
  explicit reverse-time loop with the TPU backward kernel's formulas,
  not autograd). The CPU path, and the references the kernels are held
  against on the card.
- hand-written Hopper kernels: ``bilstm_fused_kernel``
  (``csrc/bilstm_fwd.cu``) and ``bilstm_fused_bwd_kernel``
  (``csrc/bilstm_bwd.cu``). Each file's header names the TPU kernel it
  replaces, what bounds it on the card and what its design does about
  it.

``bilstm_fused`` dispatches on the device of ``x`` (``_route``): the
plain versions for a CPU tensor, the kernels for a CUDA tensor, and
nothing else. With gradients enabled it runs through ``BiLSTMFused``, a
``torch.autograd.Function`` that dispatches its forward and backward the
same way. No path falls back from a kernel to a plain version.

Semantics. Gate order (i, f, g, o) with the forget bias +1 inside the
cell; h and c stay f32 and only the products run in ``compute_dtype``.
The TPU kernel keeps the projection xg in f32 and zeroes its backward
half past each row's length (``lstm_impl: pallas``). With
``round_xg=True`` xg is rounded to ``compute_dtype`` first, which is
what the JAX scan path does (``lstm_impl: scan``,
``models/encoder.py`` there). In f32 the two are identical.
``lstm_time_chunk`` and the TPU's VMEM admission model have no
counterpart: a shape the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

from gluon_e2e_asr_tpu_torch import _build
from gluon_e2e_asr_tpu_torch.models.lstm import bilstm_scan, matmul_cd, work_dtype

MAX_HIDDEN = 1024  # one thread per hidden unit in the recurrence kernels


def _project(x, lens, w_x, b_x, compute_dtype, round_xg):
    """xg = x . w_x + b_x [B,T,8H], backward half zeroed past ``lens``."""
    H = w_x.shape[1] // 8
    xg = matmul_cd(x, w_x, compute_dtype) + b_x.to(work_dtype(x))
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None]
    xg_f, xg_b = xg[..., :4 * H], xg[..., 4 * H:] * valid[..., None]
    if round_xg:
        xg_f = xg_f.to(compute_dtype).to(xg.dtype)
        xg_b = xg_b.to(compute_dtype).to(xg.dtype)
    return xg_f, xg_b


def bilstm_fused_plain(x, lens, w_x, b_x, w_hf, w_hb,
                       compute_dtype: torch.dtype = torch.float32,
                       round_xg: bool = False, with_cell: bool = False):
    """x [B,T,D]; lens [B]; w_x [D,8H] (forward gates, then backward);
    b_x [8H]; w_hf/w_hb [H,4H]. Returns concat(fwd, bwd) [B,T,2H] f32,
    zero at t >= lens[b]; with ``with_cell`` also the c streams [B,T,2H]
    (the training form)."""
    bilstm_fused_plain.calls += 1
    xg_f, xg_b = _project(x, lens, w_x, b_x, compute_dtype, round_xg)
    return bilstm_scan(xg_f, xg_b, lens, w_hf, w_hb, compute_dtype,
                       with_cell=with_cell)


bilstm_fused_plain.calls = 0


def bilstm_fused_bwd_plain(x, lens, w_x, b_x, w_hf, w_hb, y, c, dy,
                           compute_dtype: torch.dtype = torch.float32,
                           round_xg: bool = False):
    """The VJP of ``bilstm_fused``, as the TPU backward kernel computes it:
    the gates recomputed from x and the stored h stream, then a reverse
    sweep per direction. y and c are the forward's h and c streams
    [B,T,2H], dy the cotangent of y. Returns (dx [B,T,D], dw_x [D,8H],
    db [8H], dw_hf [H,4H], dw_hb [H,4H])."""
    bilstm_fused_bwd_plain.calls += 1
    B, T, D = x.shape
    H = w_hf.shape[0]
    work = work_dtype(x, y)
    valid = (torch.arange(T, device=x.device)[None, :] < lens[:, None])
    vm = valid[..., None].to(work)
    xg = torch.cat(_project(x, lens, w_x, b_x, compute_dtype, round_xg), -1)
    dy = dy.to(work) * vm
    zero = torch.zeros(B, 1, H, device=x.device, dtype=work)
    dgs, dwh = [], []
    for d, w_h in enumerate((w_hf, w_hb)):
        hs, cs = y[..., d * H:(d + 1) * H], c[..., d * H:(d + 1) * H]
        # The "previous" state: t-1 forward, t+1 backward, 0 outside.
        if d == 0:
            h_prev = torch.cat([zero, hs[:, :-1]], 1)
            c_prev = torch.cat([zero, cs[:, :-1]], 1)
        else:
            h_prev = torch.cat([hs[:, 1:], zero], 1)
            c_prev = torch.cat([cs[:, 1:], zero], 1)
        gates = xg[..., d * 4 * H:(d + 1) * 4 * H] \
            + matmul_cd(h_prev, w_h, compute_dtype)
        gi, gf, gg, go = torch.chunk(gates, 4, dim=-1)
        si, sf = torch.sigmoid(gi) * vm, torch.sigmoid(gf + 1.0) * vm
        tg, so = torch.tanh(gg) * vm, torch.sigmoid(go) * vm
        th = torch.tanh(cs)
        dh_rec = torch.zeros(B, H, device=x.device, dtype=work)
        dc_carry = torch.zeros_like(dh_rec)
        dg = torch.empty(B, T, 4 * H, device=x.device, dtype=work)
        for t in (range(T - 1, -1, -1) if d == 0 else range(T)):
            dh = dy[:, t, d * H:(d + 1) * H] + dh_rec
            d_o = dh * th[:, t]
            dc = dh * so[:, t] * (1.0 - th[:, t] ** 2) + dc_carry
            g = torch.cat([
                dc * tg[:, t] * si[:, t] * (1.0 - si[:, t]),
                dc * c_prev[:, t] * sf[:, t] * (1.0 - sf[:, t]),
                dc * si[:, t] * (1.0 - tg[:, t] ** 2),
                d_o * so[:, t] * (1.0 - so[:, t]),
            ], dim=-1)
            dh_rec = matmul_cd(g, w_h.T, compute_dtype)
            dc_carry = dc * sf[:, t]
            dg[:, t] = g
        dgs.append(dg)
        dwh.append(matmul_cd(h_prev.reshape(-1, H).T, dg.reshape(-1, 4 * H),
                             compute_dtype))
    dg = torch.cat(dgs, -1)  # [B,T,8H]
    dx = matmul_cd(dg, w_x.T, compute_dtype)
    dw_x = matmul_cd(x.reshape(-1, D).T, dg.reshape(-1, 8 * H), compute_dtype)
    return dx, dw_x, dg.sum((0, 1)), dwh[0], dwh[1]


bilstm_fused_bwd_plain.calls = 0


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load_library(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        n_ptr, n_int = {"bilstm_fwd": (9, 6), "bilstm_bwd": (15, 5)}[name]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, {"bilstm_fwd": "bilstm_error_string",
                            "bilstm_bwd": "bilstm_bwd_error_string"}[name])
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_layer(x, lens, w_x, w_hf, w_hb, compute_dtype, who: str):
    """(B, T, D, H) of a layer the kernels can take; raises otherwise."""
    if x.device.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B,T,D], got {tuple(x.shape)}")
    B, T, D = x.shape
    H = w_hf.shape[0]
    if not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"hidden size {H} outside the kernel's 1..{MAX_HIDDEN}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")
    dev = x.device
    _check(x, "x", torch.float32, (B, T, D), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    _check(w_x, "w_x", torch.float32, (D, 8 * H), dev)
    _check(w_hf, "w_hf", torch.float32, (H, 4 * H), dev)
    _check(w_hb, "w_hb", torch.float32, (H, 4 * H), dev)
    return B, T, D, H


def _interleave_gates(w_h: torch.Tensor) -> torch.Tensor:
    """[H, 4H] gate-major (i|f|g|o) -> [H, 4H] with column 4u+g holding
    gate g of unit u (K1-fwd's layout)."""
    H = w_h.shape[0]
    return w_h.reshape(H, 4, H).transpose(1, 2).reshape(H, 4 * H).contiguous()


def _transpose_quads(w_h: torch.Tensor) -> torch.Tensor:
    """[H, 4H] -> flat [H * 4H] with w[(q*H + u)*4 + e] = w_h[u, 4q + e]
    (K1-bwd's layout for dh_rec = dg . W_h^T)."""
    H = w_h.shape[0]
    return w_h.reshape(H, H, 4).transpose(0, 1).contiguous().reshape(-1)


def bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb,
                        compute_dtype: torch.dtype = torch.float32,
                        round_xg: bool = False, with_cell: bool = False):
    """K1-fwd on the card. Same contract as ``bilstm_fused_plain``; x,
    w_x, b_x, w_hf, w_hb f32 and lens int32, all contiguous on one CUDA
    device. ``with_cell`` selects the training form and returns (y, c,
    acts): the h and c streams [B,T,2H] and the gate activations
    [B,T,8H] (sig(i), sig(f+1), tanh(g), sig(o) in w_x's column layout,
    0 past lens), which ``bilstm_fused_bwd_kernel`` consumes."""
    B, T, D, H = _check_layer(x, lens, w_x, w_hf, w_hb, compute_dtype,
                              "bilstm_fused_kernel")
    dev = x.device
    _check(b_x, "b_x", torch.float32, (8 * H,), dev)
    y = torch.empty(B, T, 2 * H, device=dev, dtype=torch.float32)
    c = torch.empty_like(y) if with_cell else None
    xg = torch.empty(B, T, 8 * H, device=dev, dtype=torch.float32)
    if B == 0 or T == 0:
        return (y, c, xg) if with_cell else y
    # The recurrent weights are read from L2 every step: ship them in the
    # compute dtype (the TPU wrapper casts them the same way), with each
    # hidden unit's four gate columns adjacent (one vector load).
    whf = _interleave_gates(w_hf).to(compute_dtype)
    whb = _interleave_gates(w_hb).to(compute_dtype)
    lib = _lib("bilstm_fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.bilstm_fwd(
            x.data_ptr(), lens.data_ptr(), w_x.data_ptr(), b_x.data_ptr(),
            whf.data_ptr(), whb.data_ptr(), xg.data_ptr(), y.data_ptr(),
            c.data_ptr() if with_cell else None,
            B, T, D, H, int(compute_dtype == torch.bfloat16), int(round_xg),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"bilstm_fwd launch failed: {lib.bilstm_error_string(rc).decode()} "
            f"(B={B} T={T} D={D} H={H})")
    bilstm_fused_kernel.launches += 1
    return (y, c, xg) if with_cell else y


bilstm_fused_kernel.launches = 0


def bilstm_fused_bwd_kernel(x, lens, w_x, w_hf, w_hb, y, c, acts, dy,
                            compute_dtype: torch.dtype = torch.float32):
    """K1-bwd on the card: the VJP from the training form of K1-fwd's
    outputs (y, c, acts of ``bilstm_fused_kernel(..., with_cell=True)``)
    and the cotangent dy [B,T,2H]. Returns what
    ``bilstm_fused_bwd_plain`` returns."""
    B, T, D, H = _check_layer(x, lens, w_x, w_hf, w_hb, compute_dtype,
                              "bilstm_fused_bwd_kernel")
    dev = x.device
    _check(y, "y", torch.float32, (B, T, 2 * H), dev)
    _check(c, "c", torch.float32, (B, T, 2 * H), dev)
    _check(acts, "acts", torch.float32, (B, T, 8 * H), dev)
    if dy.shape != y.shape or dy.device != dev:
        raise ValueError(f"dy must be {tuple(y.shape)} on {dev}, "
                         f"got {tuple(dy.shape)} on {dy.device}")
    dy = dy.to(torch.float32).contiguous()
    f32 = dict(device=dev, dtype=torch.float32)
    dx = torch.empty(B, T, D, **f32)
    dw_x = torch.empty(D, 8 * H, **f32)
    db = torch.empty(8 * H, **f32)
    dw_hf = torch.empty(H, 4 * H, **f32)
    dw_hb = torch.empty(H, 4 * H, **f32)
    if B == 0 or T == 0:
        return dx, dw_x.zero_(), db.zero_(), dw_hf.zero_(), dw_hb.zero_()
    dg = torch.empty(B, T, 8 * H, **f32)
    wtf = _transpose_quads(w_hf).to(compute_dtype)
    wtb = _transpose_quads(w_hb).to(compute_dtype)
    lib = _lib("bilstm_bwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.bilstm_bwd(
            x.data_ptr(), lens.data_ptr(), w_x.data_ptr(), wtf.data_ptr(),
            wtb.data_ptr(), y.data_ptr(), c.data_ptr(), acts.data_ptr(),
            dy.data_ptr(), dg.data_ptr(), dx.data_ptr(), dw_x.data_ptr(),
            db.data_ptr(), dw_hf.data_ptr(), dw_hb.data_ptr(),
            B, T, D, H, int(compute_dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(
            f"bilstm_bwd launch failed: "
            f"{lib.bilstm_bwd_error_string(rc).decode()} "
            f"(B={B} T={T} D={D} H={H})")
    bilstm_fused_bwd_kernel.launches += 1
    return dx, dw_x, db, dw_hf, dw_hb


bilstm_fused_bwd_kernel.launches = 0


def _route(x: torch.Tensor) -> str:
    """"plain" for a CPU tensor, "kernel" for a CUDA tensor."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "kernel"
    raise ValueError(f"bilstm_fused: no implementation for device {x.device}")


class BiLSTMFused(torch.autograd.Function):
    """``bilstm_fused`` with its gradient: the plain forward and backward
    for CPU tensors, K1-fwd (training form) and K1-bwd for CUDA tensors.
    The gradient comes back in the caller's (i, f, g, o) layout; lens,
    compute_dtype and round_xg get none."""

    @staticmethod
    def forward(ctx, x, lens, w_x, b_x, w_hf, w_hb, compute_dtype, round_xg):
        args = (x, lens, w_x, b_x, w_hf, w_hb, compute_dtype, round_xg)
        if _route(x) == "plain":
            (y, c), acts = bilstm_fused_plain(*args, with_cell=True), None
        else:
            y, c, acts = bilstm_fused_kernel(*args, with_cell=True)
        ctx.save_for_backward(x, lens, w_x, b_x, w_hf, w_hb, y, c, acts)
        ctx.compute_dtype, ctx.round_xg = compute_dtype, round_xg
        return y

    @staticmethod
    def backward(ctx, dy):
        x, lens, w_x, b_x, w_hf, w_hb, y, c, acts = ctx.saved_tensors
        if _route(x) == "plain":
            grads = bilstm_fused_bwd_plain(
                x, lens, w_x, b_x, w_hf, w_hb, y, c, dy, ctx.compute_dtype,
                ctx.round_xg)
        else:
            grads = bilstm_fused_bwd_kernel(
                x, lens, w_x, w_hf, w_hb, y, c, acts, dy, ctx.compute_dtype)
        dx, dw_x, db, dw_hf, dw_hb = grads
        return dx, None, dw_x, db, dw_hf, dw_hb, None, None


def bilstm_fused(x, lens, w_x, b_x, w_hf, w_hb,
                 compute_dtype: torch.dtype = torch.float32,
                 round_xg: bool = False) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors;
    through ``BiLSTMFused`` when a gradient is wanted."""
    route = _route(x)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_x, b_x, w_hf, w_hb)):
        return BiLSTMFused.apply(x, lens, w_x, b_x, w_hf, w_hb,
                                 compute_dtype, round_xg)
    if route == "plain":
        return bilstm_fused_plain(x, lens, w_x, b_x, w_hf, w_hb,
                                  compute_dtype, round_xg)
    return bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb,
                               compute_dtype, round_xg)
