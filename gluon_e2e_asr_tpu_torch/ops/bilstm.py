"""One BiLSTM layer: K1-fwd and K1-bwd (projection fused), K7-fwd and
K7-bwd (the v1 layer over given projections).

Counterpart of ``gluon_e2e_asr_tpu/ops/pallas_lstm.py``: ``bilstm_fused``
(forward and VJP) and ``bilstm_pallas`` (forward and VJP), below. Each
direction of ``bilstm_fused`` has two versions:

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

Each recurrence takes one of two kernels, chosen by shape alone: for
H <= ``CLUSTER_MAX_HIDDEN`` (320, every config of the repo) a kernel that
keeps W_h resident in the shared memory of a cluster of 16 CTAs, for
320 < H <= ``MAX_HIDDEN`` one that reads W_h from L2 every step.

- K1-fwd's (and K7-fwd's) recurrence (``csrc/bilstm_fwd.cu``,
  ``_fwd_weights``): ``fwd_cluster_kernel``, whose CTAs each hold W_h's
  gate columns of their units and all-gather h through distributed shared
  memory (W_h shipped as ``_cluster_fwd_slices``), or ``recur_kernel``
  (W_h shipped as ``_interleave_gates``).
- K1-fwd's projection xg = x . W_x + b (``csrc/bilstm_fwd.cu``): in
  bf16 the wgmma kernel of ``csrc/proj_sm90.cuh``, in f32
  ``csrc/gemm_f32.cuh``'s ``ring_kernel`` on the FMA units; also alone
  through ``bilstm_fused_proj_kernel`` (plain twin
  ``bilstm_fused_proj_plain``), whose ``.launches`` count every bf16
  launch and ``.f32_launches`` every f32 one, K1-fwd's included.
- K1-bwd's products dx, dW_x, dW_h and db (``csrc/bilstm_bwd.cu``,
  ``bilstm_fused_bwd_products_kernel``, plain twin
  ``bilstm_fused_bwd_products_plain``): in bf16 the wgmma kernels of
  ``csrc/gemm_sm90.cuh``, in f32 ``ring_kernel``; ``.launches`` counts
  every call, K1-bwd's included, and ``.f32_launches`` the f32 ones.
- K1-bwd's (and K7-bwd's) reverse recurrence (``csrc/bilstm_bwd.cu``,
  ``_bwd_weights``): ``bwd_cluster_kernel``, which sums dh_rec by a
  reduce-scatter through distributed shared memory (W_h shipped as
  ``_cluster_slices``), or ``bwd_recur_kernel`` (``_transpose_quads``).

Each kernel wrapper counts its launches in ``.launches`` and those
through the cluster kernel in ``.cluster_launches``. A failed launch of
either raises; neither replaces the other.

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

``bilstm_pallas`` (K7, the v1 layer) takes the projections xg_f, xg_b
[B,T,4H] and runs the same recurrence; as in JAX, nothing in ``models/``
calls it. Its h and c streams come out in xg's dtype, and its backward
reads those rounded streams (``_bilstm_vjp_bwd``); with bf16 projections
and an f32 compute dtype the kernel's backward recomputes the gates from
the rounded h stream first (``_recompute_gates``), as the TPU kernel does,
since the forward's product took h unrounded. Plain versions:
``bilstm_pallas_plain`` (``models/lstm.py::bilstm_scan``) and
``bilstm_pallas_bwd_plain`` (the reverse sweep of
``bilstm_fused_bwd_plain``); kernels: ``bilstm_pallas_kernel``
(``csrc/bilstm_fwd.cu::bilstm_v1_fwd``) and ``bilstm_pallas_bwd_kernel``
(``csrc/bilstm_bwd.cu::bilstm_v1_bwd``), dispatched by ``_route`` as
above.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gluon_e2e_asr_tpu_torch import _build
from gluon_e2e_asr_tpu_torch.models.lstm import bilstm_scan, matmul_cd, work_dtype

MAX_HIDDEN = 1024  # one thread per hidden unit in the L2 recurrence kernels
CLUSTER_CTAS = 16  # CTAs of a cluster of the cluster recurrences
CLUSTER_MAX_HIDDEN = 320  # the largest H they take (their shared memory)


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


def _bwd_sweep(xg, lens, w_hf, w_hb, y, c, dy, compute_dtype):
    """The reverse sweep of the TPU backward kernels (``_bwd_kernel``,
    ``_v2_bwd_kernel``), shared by K1's and K7's plain backward: the gates
    recomputed from the projections xg [B,T,8H] and the h stream y, c_prev
    from the c stream c (both [B,T,2H], as stored), then per direction,
    against its time order, the cell's derivatives. Returns dg [B,T,8H],
    0 at t >= lens[b]."""
    B, T, _ = xg.shape
    H = w_hf.shape[0]
    work = work_dtype(xg, y)
    valid = (torch.arange(T, device=xg.device)[None, :] < lens[:, None])
    vm = valid[..., None].to(work)
    dy = dy.to(work) * vm
    y, c = y.to(work), c.to(work)
    zero = torch.zeros(B, 1, H, device=xg.device, dtype=work)
    dgs = []
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
        dh_rec = torch.zeros(B, H, device=xg.device, dtype=work)
        dc_carry = torch.zeros_like(dh_rec)
        dg = torch.empty(B, T, 4 * H, device=xg.device, dtype=work)
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
    return torch.cat(dgs, -1)


def _dw_h(y, dg, compute_dtype):
    """dW_h of both directions [H,4H]: h_prev^T . dg of the direction's 4H
    columns, h_prev the h stream y [B,T,2H] at t-1 (forward) or t+1
    (backward), 0 outside [0, T)."""
    B, T, H2 = y.shape
    H = H2 // 2
    work = work_dtype(dg, y)
    y = y.to(work)
    zero = torch.zeros(B, 1, H, device=y.device, dtype=work)
    out = []
    for d in range(2):
        hs = y[..., d * H:(d + 1) * H]
        h_prev = (torch.cat([zero, hs[:, :-1]], 1) if d == 0
                  else torch.cat([hs[:, 1:], zero], 1))
        g = dg[..., d * 4 * H:(d + 1) * 4 * H].contiguous()
        out.append(matmul_cd(h_prev.reshape(-1, H).T, g.reshape(-1, 4 * H),
                             compute_dtype))
    return out


def bilstm_fused_bwd_products_plain(x, lens, w_x, y, dg,
                                    compute_dtype: torch.dtype = torch.float32):
    """K1-bwd's products after the reverse sweep, from dg [B,T,8H]: dx =
    dg . W_x^T [B,T,D], dw_x = x^T . dg [D,8H], db = the sum of dg [8H],
    and dw_hf, dw_hb [H,4H] (``_dw_h``), the operands rounded to
    ``compute_dtype`` and the sums in f32 (db over the unrounded dg). lens
    is not read: dg is 0 past it, which the kernel
    (``bilstm_fused_bwd_products_kernel``) uses to skip those frames."""
    bilstm_fused_bwd_products_plain.calls += 1
    D = x.shape[-1]
    dx = matmul_cd(dg, w_x.T, compute_dtype)
    dw_x = matmul_cd(x.reshape(-1, D).T, dg.reshape(-1, dg.shape[-1]),
                     compute_dtype)
    dw_hf, dw_hb = _dw_h(y, dg, compute_dtype)
    return dx, dw_x, dg.sum((0, 1)), dw_hf, dw_hb


bilstm_fused_bwd_products_plain.calls = 0


def bilstm_fused_bwd_plain(x, lens, w_x, b_x, w_hf, w_hb, y, c, dy,
                           compute_dtype: torch.dtype = torch.float32,
                           round_xg: bool = False):
    """The VJP of ``bilstm_fused``, as the TPU backward kernel computes it:
    the gates recomputed from x and the stored h stream, then a reverse
    sweep per direction, then the products
    (``bilstm_fused_bwd_products_plain``). y and c are the forward's h and
    c streams [B,T,2H], dy the cotangent of y. Returns (dx [B,T,D], dw_x
    [D,8H], db [8H], dw_hf [H,4H], dw_hb [H,4H])."""
    bilstm_fused_bwd_plain.calls += 1
    xg = torch.cat(_project(x, lens, w_x, b_x, compute_dtype, round_xg), -1)
    dg = _bwd_sweep(xg, lens, w_hf, w_hb, y, c, dy, compute_dtype)
    return bilstm_fused_bwd_products_plain(x, lens, w_x, y, dg, compute_dtype)


bilstm_fused_bwd_plain.calls = 0


# Each library's entry points: (pointer arguments, int arguments), then
# the stream.
_ENTRIES = {"bilstm_fwd": {"bilstm_fwd": (10, 8), "bilstm_fwd_proj": (6, 8),
                           "bilstm_v1_fwd": (8, 6),
                           "bilstm_fwd_recur": (6, 4),
                           "bilstm_fwd_cluster_plan": (2, 3)},
            "bilstm_bwd": {"bilstm_bwd_products": (12, 8),
                           "bilstm_v1_bwd": (11, 6),
                           "bilstm_bwd_workspace": (1, 6),
                           "bilstm_v1_gates": (7, 3),
                           "bilstm_bwd_recur": (7, 4),
                           "bilstm_bwd_cluster_plan": (2, 3)}}
_ERRORS = {"bilstm_fwd": "bilstm_error_string",
           "bilstm_bwd": "bilstm_bwd_error_string"}


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load_library(name)
    err = getattr(lib, _ERRORS[name])
    if err.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        for entry, (n_ptr, n_int) in _ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _launch(name: str, entry: str, dev: torch.device, args, what: str) -> None:
    """Call ``entry`` of library ``name`` on ``dev``'s current stream;
    raise with ``what`` (the shapes) if the launch failed."""
    lib = _lib(name)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{entry} launch failed: "
            f"{getattr(lib, _ERRORS[name])(rc).decode()} ({what})")


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


def _cluster_units(H: int) -> int:
    """Hidden units owned by one CTA of the cluster recurrence: a multiple
    of 4 (one 16-byte store), 16 of them cover H."""
    return 4 * -(-H // 64)


def _cluster_slices(w_h: torch.Tensor) -> torch.Tensor:
    """[H, 4H] gate-major (i|f|g|o) -> [16, 4U, 16U], U = _cluster_units(H):
    slice r, row j = 4*lu + g, column u' holds W_h[u', g*H + r*U + lu] (the
    weights of CTA r's dg columns, K1-bwd's cluster layout); 0 where
    r*U + lu >= H or u' >= H."""
    H = w_h.shape[0]
    U = _cluster_units(H)
    Hp = CLUSTER_CTAS * U
    w = w_h.new_zeros(Hp, 4, Hp)  # [u', g, unit]
    w[:H, :, :H] = w_h.reshape(H, 4, H)
    return (w.reshape(Hp, 4, CLUSTER_CTAS, U).permute(2, 3, 1, 0)
            .reshape(CLUSTER_CTAS, 4 * U, Hp).contiguous())


def _cluster_fwd_slices(w_h: torch.Tensor) -> torch.Tensor:
    """[H, 4H] gate-major (i|f|g|o) -> [16, 16U, 4U], U = _cluster_units(H):
    slice r, row k, column j = 4*lu + g holds W_h[k, g*H + r*U + lu] (the
    weights of CTA r's gate columns, K1-fwd's cluster layout: columns
    [4rU, 4rU + 4U) of ``_interleave_gates``, padded); 0 where
    r*U + lu >= H or k >= H."""
    H = w_h.shape[0]
    U = _cluster_units(H)
    Hp = CLUSTER_CTAS * U
    w = w_h.new_zeros(Hp, 4, Hp)  # [k, g, unit]
    w[:H, :, :H] = w_h.reshape(H, 4, H)
    return (w.reshape(Hp, 4, CLUSTER_CTAS, U).permute(2, 0, 3, 1)
            .reshape(CLUSTER_CTAS, Hp, 4 * U).contiguous())


def _fwd_weights(w_hf, w_hb, compute_dtype):
    """W_h of both directions in the layout of the forward recurrence
    kernel that H selects, in the compute dtype (the TPU wrapper casts
    them the same way), and whether it is the cluster kernel."""
    cluster = w_hf.shape[0] <= CLUSTER_MAX_HIDDEN
    layout = _cluster_fwd_slices if cluster else _interleave_gates
    return (layout(w_hf).to(compute_dtype), layout(w_hb).to(compute_dtype),
            cluster)


def _bwd_weights(w_hf, w_hb, compute_dtype):
    """W_h of both directions in the layout of the recurrence kernel that
    H selects, in the compute dtype, and whether it is the cluster
    kernel."""
    cluster = w_hf.shape[0] <= CLUSTER_MAX_HIDDEN
    layout = _cluster_slices if cluster else _transpose_quads
    return (layout(w_hf).to(compute_dtype), layout(w_hb).to(compute_dtype),
            cluster)


def _proj_operands(x, w_x, compute_dtype):
    """x and W_x as the projection kernel reads them: in f32, x and W_x
    as they are; in bf16, x with rows padded to a multiple of 4 floats (a
    TMA box starts on a 16-byte boundary) and scratch for W_x's bf16
    copy, which the kernel's entry lays out as W_x^T [8H][ldw], ldw = D
    rounded up to 8 (the K-major tile of the wgmma products; the rounding
    the product applies anyway). Returns (x, its row length, the scratch
    or None, ldw)."""
    D = x.shape[-1]
    if compute_dtype != torch.bfloat16:
        return x, D, None, D
    if D % 4:
        x = torch.nn.functional.pad(x, (0, -D % 4))
    elif x.data_ptr() % 16:  # a view at an odd offset
        x = x.clone()
    ldw = D + -D % 8
    wt16 = w_x.new_empty(w_x.shape[1], ldw, dtype=torch.bfloat16)
    return x, x.shape[-1], wt16, ldw


def bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb,
                        compute_dtype: torch.dtype = torch.float32,
                        round_xg: bool = False, with_cell: bool = False):
    """K1-fwd on the card. Same contract as ``bilstm_fused_plain``; x,
    w_x, b_x, w_hf, w_hb f32 and lens int32, all contiguous on one CUDA
    device. ``with_cell`` selects the training form and returns (y, c,
    acts): the h and c streams [B,T,2H] and the gate activations
    [B,T,8H] (sig(i), sig(f+1), tanh(g), sig(o) in w_x's column layout,
    0 past lens), which ``bilstm_fused_bwd_kernel`` consumes. Its
    projection is the kernel of ``bilstm_fused_proj_kernel``, whose
    ``.launches`` count the bf16 ones (wgmma) and ``.f32_launches`` the
    f32 ones (``ring_kernel``)."""
    B, T, D, H = _check_layer(x, lens, w_x, w_hf, w_hb, compute_dtype,
                              "bilstm_fused_kernel")
    dev = x.device
    _check(b_x, "b_x", torch.float32, (8 * H,), dev)
    y = torch.empty(B, T, 2 * H, device=dev, dtype=torch.float32)
    c = torch.empty_like(y) if with_cell else None
    xg = torch.empty(B, T, 8 * H, device=dev, dtype=torch.float32)
    if B == 0 or T == 0:
        return (y, c, xg) if with_cell else y
    whf, whb, cluster = _fwd_weights(w_hf, w_hb, compute_dtype)
    bf16 = compute_dtype == torch.bfloat16
    xp, ldx, wt16, ldw = _proj_operands(x, w_x, compute_dtype)
    _launch("bilstm_fwd", "bilstm_fwd", dev, (
        xp.data_ptr(), lens.data_ptr(), w_x.data_ptr(),
        wt16.data_ptr() if bf16 else None, b_x.data_ptr(),
        whf.data_ptr(), whb.data_ptr(), xg.data_ptr(), y.data_ptr(),
        c.data_ptr() if with_cell else None,
        B, T, D, H, ldx, ldw, int(bf16), int(round_xg)),
        f"B={B} T={T} D={D} H={H}")
    bilstm_fused_kernel.launches += 1
    bilstm_fused_kernel.cluster_launches += cluster
    bilstm_fused_proj_kernel.launches += bf16
    bilstm_fused_proj_kernel.f32_launches += not bf16
    return (y, c, xg) if with_cell else y


bilstm_fused_kernel.launches = 0
bilstm_fused_kernel.cluster_launches = 0


def bilstm_fused_proj_plain(x, lens, w_x, b_x,
                            compute_dtype: torch.dtype = torch.float32,
                            round_xg: bool = False):
    """K1-fwd's projection alone: xg [B,T,8H] as ``bilstm_fused_plain``
    forms it (``_project``, both halves), the plain twin of
    ``bilstm_fused_proj_kernel``."""
    bilstm_fused_proj_plain.calls += 1
    return torch.cat(_project(x, lens, w_x, b_x, compute_dtype, round_xg), -1)


bilstm_fused_proj_plain.calls = 0


def bilstm_fused_proj_kernel(x, lens, w_x, b_x,
                             compute_dtype: torch.dtype = torch.float32,
                             round_xg: bool = False):
    """K1-fwd's projection alone on the card (``csrc/bilstm_fwd.cu::
    bilstm_fwd_proj``): what ``bilstm_fused_proj_plain`` returns, from
    x [B,T,D], lens, w_x [D,8H] and b_x [8H], f32 (lens int32) and
    contiguous on one CUDA device. In bf16 the wgmma kernel
    (``csrc/proj_sm90.cuh``), counted in ``.launches``; in f32
    ``csrc/gemm_f32.cuh``'s ``ring_kernel``, counted in ``.f32_launches``
    (both count those inside ``bilstm_fused_kernel`` too). For timing and
    checking the projection apart from the recurrence."""
    if x.dim() != 3 or w_x.dim() != 2 or w_x.shape[-1] % 8:
        raise ValueError(f"x must be [B,T,D] and w_x [D,8H], got "
                         f"{tuple(x.shape)} and {tuple(w_x.shape)}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")
    B, T, D = x.shape
    H = w_x.shape[-1] // 8
    dev = x.device
    _check(x, "x", torch.float32, (B, T, D), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    _check(w_x, "w_x", torch.float32, (D, 8 * H), dev)
    _check(b_x, "b_x", torch.float32, (8 * H,), dev)
    if dev.type != "cuda":
        raise ValueError(f"bilstm_fused_proj_kernel needs CUDA tensors, "
                         f"got {dev}")
    xg = torch.empty(B, T, 8 * H, device=dev, dtype=torch.float32)
    if B == 0 or T == 0 or H == 0:
        return xg
    bf16 = compute_dtype == torch.bfloat16
    xp, ldx, wt16, ldw = _proj_operands(x, w_x, compute_dtype)
    _launch("bilstm_fwd", "bilstm_fwd_proj", dev, (
        xp.data_ptr(), lens.data_ptr(), w_x.data_ptr(),
        wt16.data_ptr() if bf16 else None, b_x.data_ptr(), xg.data_ptr(),
        B, T, D, H, ldx, ldw, int(bf16), int(round_xg)),
        f"B={B} T={T} D={D} H={H}")
    bilstm_fused_proj_kernel.launches += bf16
    bilstm_fused_proj_kernel.f32_launches += not bf16
    return xg


bilstm_fused_proj_kernel.launches = 0
bilstm_fused_proj_kernel.f32_launches = 0


def bilstm_fused_fwd_recur_kernel(xg, lens, w_hf, w_hb,
                                  compute_dtype: torch.dtype = torch.float32,
                                  with_cell: bool = False):
    """K1-fwd's recurrence alone on the card (the kernel H selects), over
    a projection xg [B,T,8H] f32 as ``bilstm_fused_kernel`` forms it (the
    backward half 0 past lens). Returns y [B,T,2H] and, with
    ``with_cell``, (y, c), in which case xg is overwritten with the gate
    activations. For timing the recurrence apart from the projection; no
    model path calls it."""
    B, T, H8 = xg.shape
    H = H8 // 8
    dev = xg.device
    if dev.type != "cuda":
        raise ValueError(f"bilstm_fused_fwd_recur_kernel needs CUDA tensors, "
                         f"got {dev}")
    if not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"hidden size {H} outside the kernel's 1..{MAX_HIDDEN}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")
    _check(xg, "xg", torch.float32, (B, T, 8 * H), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    _check(w_hf, "w_hf", torch.float32, (H, 4 * H), dev)
    _check(w_hb, "w_hb", torch.float32, (H, 4 * H), dev)
    y = torch.empty(B, T, 2 * H, device=dev, dtype=torch.float32)
    c = torch.empty_like(y) if with_cell else None
    if B and T:
        whf, whb, cluster = _fwd_weights(w_hf, w_hb, compute_dtype)
        _launch("bilstm_fwd", "bilstm_fwd_recur", dev, (
            xg.data_ptr(), lens.data_ptr(), whf.data_ptr(), whb.data_ptr(),
            y.data_ptr(), c.data_ptr() if with_cell else None, B, T, H,
            int(compute_dtype == torch.bfloat16)), f"B={B} T={T} H={H}")
        bilstm_fused_fwd_recur_kernel.launches += 1
        bilstm_fused_fwd_recur_kernel.cluster_launches += cluster
    return (y, c) if with_cell else y


bilstm_fused_fwd_recur_kernel.launches = 0
bilstm_fused_fwd_recur_kernel.cluster_launches = 0


@functools.lru_cache(maxsize=256)
def _workspace_floats(dev: torch.device, B, T, D, H, with_x: bool,
                      bf16: bool) -> int:
    """The library's ``bilstm_bwd_workspace`` for a shape on ``dev`` (its
    split plans take the card's SMs), asked once a shape."""
    n = ctypes.c_longlong(0)
    _launch("bilstm_bwd", "bilstm_bwd_workspace", dev, (
        ctypes.addressof(n), B, T, D, H, int(with_x), int(bf16)),
        f"B={B} T={T} D={D} H={H}")
    return n.value


def _products_workspace(dev, B, T, D, H, with_x: bool, bf16: bool):
    """The workspace K1-bwd's products (``with_x``) or K7-bwd's dW_h take
    at a shape, from PyTorch's caching allocator: the parts of their
    split-K splits, which ``csrc/split_sum.cuh`` adds in the fixed order
    0, 1, ..., S - 1. Returns (the tensor, its pointer or None)."""
    n = _workspace_floats(dev, B, T, D, H, with_x, bf16)
    ws = torch.empty(n, device=dev, dtype=torch.float32)
    return ws, (ws.data_ptr() if n else None)


def _h_rows(y):
    """The h stream y [B,T,2H] as the bf16 products' tensor maps take it:
    rows of a multiple of 16 bytes with the backward direction's h at a
    16-byte boundary. For H % 4 != 0 (never in the repo's configs) a
    copy with each direction's H columns padded to a multiple of 4.
    Returns (y, the backward direction's first column)."""
    H = y.shape[-1] // 2
    if H % 4 == 0:
        return y, H
    Hp = H + -H % 4
    yp = y.new_zeros(*y.shape[:-1], 2 * Hp)
    yp[..., :H] = y[..., :H]
    yp[..., Hp:Hp + H] = y[..., H:]
    return yp, Hp


def _bwd_recurrence(lens, w_hf, w_hb, c, acts, dy, compute_dtype):
    """Launch K1-bwd's reverse recurrence (the kernel H selects); returns dg
    [B,T,8H] f32 and whether the cluster kernel ran."""
    B, T, H2 = c.shape
    dg = torch.empty(B, T, 4 * H2, device=c.device, dtype=torch.float32)
    wtf, wtb, cluster = _bwd_weights(w_hf, w_hb, compute_dtype)
    _launch("bilstm_bwd", "bilstm_bwd_recur", c.device, (
        lens.data_ptr(), wtf.data_ptr(), wtb.data_ptr(), c.data_ptr(),
        acts.data_ptr(), dy.data_ptr(), dg.data_ptr(), B, T, H2 // 2,
        int(compute_dtype == torch.bfloat16)), f"B={B} T={T} H={H2 // 2}")
    return dg, cluster


def bilstm_fused_bwd_kernel(x, lens, w_x, w_hf, w_hb, y, c, acts, dy,
                            compute_dtype: torch.dtype = torch.float32):
    """K1-bwd on the card: the VJP from the training form of K1-fwd's
    outputs (y, c, acts of ``bilstm_fused_kernel(..., with_cell=True)``)
    and the cotangent dy [B,T,2H]: the reverse recurrence, then
    ``bilstm_fused_bwd_products_kernel``. Returns what
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
    if B == 0 or T == 0:
        f32 = dict(device=dev, dtype=torch.float32)
        return (torch.empty(B, T, D, **f32), torch.zeros(D, 8 * H, **f32),
                torch.zeros(8 * H, **f32), torch.zeros(H, 4 * H, **f32),
                torch.zeros(H, 4 * H, **f32))
    dg, cluster = _bwd_recurrence(lens, w_hf, w_hb, c, acts,
                                  dy.to(torch.float32).contiguous(),
                                  compute_dtype)
    bilstm_fused_bwd_kernel.launches += 1
    bilstm_fused_bwd_kernel.cluster_launches += cluster
    return bilstm_fused_bwd_products_kernel(x, lens, w_x, y, dg, compute_dtype)


bilstm_fused_bwd_kernel.launches = 0
bilstm_fused_bwd_kernel.cluster_launches = 0


def bilstm_fused_bwd_products_kernel(x, lens, w_x, y, dg,
                                     compute_dtype: torch.dtype = torch.float32):
    """K1-bwd's products on the card (``csrc/bilstm_bwd.cu::
    bilstm_bwd_products``): what ``bilstm_fused_bwd_products_plain``
    returns, from x [B,T,D], lens, w_x [D,8H], K1-fwd's h stream y
    [B,T,2H] and dg [B,T,8H], all f32 and contiguous on one CUDA device.
    dg must be 0 at t >= lens[b], as the reverse recurrence writes it: in
    bf16 (wgmma, ``csrc/gemm_sm90.cuh``) those frames are skipped, and
    W_x goes over as a bf16 copy made here (the rounding the product
    applies anyway). f32 runs on the FMA units (``csrc/gemm_f32.cuh``'s
    ``ring_kernel``, which skips them too). ``.launches`` counts every
    call, ``.f32_launches`` the f32 ones."""
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_fused_bwd_products_kernel needs CUDA "
                         f"tensors, got {x.device}")
    if x.dim() != 3 or dg.dim() != 3 or dg.shape[-1] % 8:
        raise ValueError(f"x must be [B,T,D] and dg [B,T,8H], got "
                         f"{tuple(x.shape)} and {tuple(dg.shape)}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")
    B, T, D = x.shape
    H = dg.shape[-1] // 8
    dev = x.device
    _check(x, "x", torch.float32, (B, T, D), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    _check(w_x, "w_x", torch.float32, (D, 8 * H), dev)
    _check(y, "y", torch.float32, (B, T, 2 * H), dev)
    _check(dg, "dg", torch.float32, (B, T, 8 * H), dev)
    f32 = dict(device=dev, dtype=torch.float32)
    dx = torch.empty(B, T, D, **f32)
    dw_x = torch.empty(D, 8 * H, **f32)
    db = torch.empty(8 * H, **f32)
    dw_hf = torch.empty(H, 4 * H, **f32)
    dw_hb = torch.empty(H, 4 * H, **f32)
    if B == 0 or T == 0 or H == 0:
        return dx, dw_x.zero_(), db.zero_(), dw_hf.zero_(), dw_hb.zero_()
    bf16 = compute_dtype == torch.bfloat16
    yb, w_x16 = H, None
    if bf16:
        w_x16 = w_x.to(torch.bfloat16)
        # the bf16 products' tensor maps need rows of a multiple of 16
        # bytes: pad x's rows and lay y out that way where a shape needs it
        if D % 4:
            x = torch.nn.functional.pad(x, (0, -D % 4))
        y, yb = _h_rows(y)
    ws, ws_ptr = _products_workspace(dev, B, T, D, H, True, bf16)
    _launch("bilstm_bwd", "bilstm_bwd_products", dev, (
        x.data_ptr(), lens.data_ptr(), w_x.data_ptr(),
        w_x16.data_ptr() if bf16 else None, y.data_ptr(),
        dg.data_ptr(), dx.data_ptr(), dw_x.data_ptr(), db.data_ptr(),
        dw_hf.data_ptr(), dw_hb.data_ptr(), ws_ptr, B, T, D, H, x.shape[-1],
        y.shape[-1], yb, int(bf16)), f"B={B} T={T} D={D} H={H}")
    bilstm_fused_bwd_products_kernel.launches += 1
    bilstm_fused_bwd_products_kernel.f32_launches += not bf16
    return dx, dw_x, db, dw_hf, dw_hb


bilstm_fused_bwd_products_kernel.launches = 0
bilstm_fused_bwd_products_kernel.f32_launches = 0


def bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, c, acts, dy,
                                  compute_dtype: torch.dtype = torch.float32):
    """K1-bwd's reverse recurrence alone on the card (the kernel H
    selects), from the arguments of ``bilstm_fused_bwd_kernel`` of the same
    names: dg [B,T,8H] f32, the cotangent of both directions' gate
    pre-activations (``_bwd_sweep``'s dg). For timing the recurrence apart
    from the products; the training path does not call it."""
    B, T, H2 = c.shape
    H = H2 // 2
    dev = c.device
    if dev.type != "cuda":
        raise ValueError(f"bilstm_fused_bwd_recur_kernel needs CUDA tensors, "
                         f"got {dev}")
    if not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"hidden size {H} outside the kernel's 1..{MAX_HIDDEN}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")
    _check(lens, "lens", torch.int32, (B,), dev)
    _check(w_hf, "w_hf", torch.float32, (H, 4 * H), dev)
    _check(w_hb, "w_hb", torch.float32, (H, 4 * H), dev)
    _check(c, "c", torch.float32, (B, T, 2 * H), dev)
    _check(acts, "acts", torch.float32, (B, T, 8 * H), dev)
    _check(dy, "dy", torch.float32, (B, T, 2 * H), dev)
    if not (B and T):
        return torch.empty(B, T, 8 * H, device=dev, dtype=torch.float32)
    dg, _ = _bwd_recurrence(lens, w_hf, w_hb, c, acts, dy, compute_dtype)
    bilstm_fused_bwd_recur_kernel.launches += 1
    return dg


bilstm_fused_bwd_recur_kernel.launches = 0


def cluster_plan(direction: str, B: int, H: int, compute_dtype: torch.dtype,
                 dev: torch.device) -> dict:
    """The plan of K1's cluster recurrence of ``direction`` ("fwd":
    ``fwd_cluster_kernel`` in the training form, "bwd":
    ``bwd_cluster_kernel``) for B rows at hidden size H <=
    CLUSTER_MAX_HIDDEN on the card ``dev``, as its launch asks for it:
    rows a cluster R, the launch's 2 * ceil(B / R) clusters of
    CLUSTER_CTAS CTAs, the clusters of R rows the card holds at once and
    the waves they run in. For the record: no kernel runs."""
    R, cap = ctypes.c_int(0), ctypes.c_int(0)
    lib = "bilstm_fwd" if direction == "fwd" else "bilstm_bwd"
    _launch(lib, f"{lib}_cluster_plan", dev, (
        ctypes.addressof(R), ctypes.addressof(cap), B, H,
        int(compute_dtype == torch.bfloat16)), f"B={B} H={H}")
    clusters = 2 * -(-B // R.value)
    return {"rows_per_cluster": R.value, "clusters": clusters,
            "ctas": clusters * CLUSTER_CTAS, "capacity": cap.value,
            "waves": -(-clusters // max(cap.value, 1))}


def _route(x: torch.Tensor) -> str:
    """"plain" for a CPU tensor, "kernel" for a CUDA tensor."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "kernel"
    raise ValueError(f"bilstm: no implementation for device {x.device}")


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


# ---------------------------------------------------------------------------
# K7: the v1 layer over given projections (pallas_lstm.py::bilstm_pallas)
# ---------------------------------------------------------------------------


def bilstm_pallas_plain(xg_f, xg_b, lens, w_hf, w_hb,
                        compute_dtype: torch.dtype = torch.float32,
                        with_cell: bool = False):
    """xg_f, xg_b [B,T,4H] (forward- and backward-direction projections,
    both at their own time index); lens [B]; w_hf/w_hb [H,4H]. The time
    loop of ``bilstm_scan``; returns concat(fwd, bwd) [B,T,2H] in xg's
    dtype, 0 at t >= lens[b], and with ``with_cell`` also the c streams,
    rounded the same way (the TPU kernel's ys and cs)."""
    bilstm_pallas_plain.calls += 1
    y, c = bilstm_scan(xg_f, xg_b, lens, w_hf, w_hb, compute_dtype,
                       with_cell=True)
    y, c = y.to(xg_f.dtype), c.to(xg_f.dtype)
    return (y, c) if with_cell else y


bilstm_pallas_plain.calls = 0


def bilstm_pallas_bwd_plain(xg_f, xg_b, lens, w_hf, w_hb, y, c, dy,
                            compute_dtype: torch.dtype = torch.float32):
    """The VJP of ``bilstm_pallas`` as ``_bilstm_vjp_bwd`` computes it:
    the gates recomputed from the projections and the rounded h stream y,
    c_prev and tanh(c) from the rounded c stream (y and c as
    ``bilstm_pallas_plain(..., with_cell=True)`` returns them), dy the
    cotangent of y. Returns (dxg_f, dxg_b) in xg's dtype and (dw_hf,
    dw_hb) in W's dtype, summed in f32."""
    bilstm_pallas_bwd_plain.calls += 1
    H4 = xg_f.shape[-1]
    xg = torch.cat([xg_f, xg_b], -1).to(work_dtype(xg_f, y))
    dg = _bwd_sweep(xg, lens, w_hf, w_hb, y, c, dy, compute_dtype)
    dw_hf, dw_hb = _dw_h(y, dg, compute_dtype)
    return (dg[..., :H4].to(xg_f.dtype), dg[..., H4:].to(xg_f.dtype),
            dw_hf.to(w_hf.dtype), dw_hb.to(w_hb.dtype))


bilstm_pallas_bwd_plain.calls = 0

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _check_v1(xg_f, xg_b, lens, w_hf, w_hb, compute_dtype, who: str):
    """(B, T, H) of a v1 layer the kernels can take; raises otherwise."""
    if xg_f.device.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {xg_f.device}")
    if xg_f.dim() != 3 or xg_f.shape[-1] % 4:
        raise ValueError(f"xg_f must be [B,T,4H], got {tuple(xg_f.shape)}")
    B, T, H4 = xg_f.shape
    H = H4 // 4
    if not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"hidden size {H} outside the kernel's 1..{MAX_HIDDEN}")
    if compute_dtype not in _STREAM_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype}")
    if xg_f.dtype not in _STREAM_DTYPES or w_hf.dtype not in _STREAM_DTYPES:
        raise ValueError(f"xg and W_h must be float32 or bfloat16, got "
                         f"{xg_f.dtype}, {w_hf.dtype}")
    dev = xg_f.device
    _check(xg_f, "xg_f", xg_f.dtype, (B, T, H4), dev)
    _check(xg_b, "xg_b", xg_f.dtype, (B, T, H4), dev)
    _check(lens, "lens", torch.int32, (B,), dev)
    _check(w_hf, "w_hf", w_hf.dtype, (H, H4), dev)
    _check(w_hb, "w_hb", w_hf.dtype, (H, H4), dev)
    return B, T, H


def bilstm_pallas_kernel(xg_f, xg_b, lens, w_hf, w_hb,
                         compute_dtype: torch.dtype = torch.float32,
                         with_cell: bool = False):
    """K7-fwd on the card. Same contract as ``bilstm_pallas_plain``:
    xg_f, xg_b f32 or bf16, W_h f32 or bf16, lens int32, all contiguous
    on one CUDA device. With ``with_cell``, the training form: (y, c,
    acts), the h and c streams [B,T,2H] as f32 tensors holding xg's
    dtype's values and the gate activations [B,T,8H] f32, which
    ``bilstm_pallas_bwd_kernel`` consumes."""
    B, T, H = _check_v1(xg_f, xg_b, lens, w_hf, w_hb, compute_dtype,
                        "bilstm_pallas_kernel")
    dev = xg_f.device
    f32 = dict(device=dev, dtype=torch.float32)
    y = torch.empty(B, T, 2 * H, **f32)
    c = torch.empty_like(y) if with_cell else None
    acts = torch.empty(B, T, 8 * H, **f32) if with_cell else None
    if B and T:
        whf, whb, cluster = _fwd_weights(w_hf, w_hb, compute_dtype)
        x_bf16 = int(xg_f.dtype == torch.bfloat16)
        _launch("bilstm_fwd", "bilstm_v1_fwd", dev, (
            xg_f.data_ptr(), xg_b.data_ptr(), lens.data_ptr(), whf.data_ptr(),
            whb.data_ptr(), y.data_ptr(), c.data_ptr() if with_cell else None,
            acts.data_ptr() if with_cell else None, B, T, H,
            int(compute_dtype == torch.bfloat16), x_bf16, x_bf16),
            f"B={B} T={T} H={H}")
        bilstm_pallas_kernel.launches += 1
        bilstm_pallas_kernel.cluster_launches += cluster
    return (y, c, acts) if with_cell else y.to(xg_f.dtype)


bilstm_pallas_kernel.launches = 0
bilstm_pallas_kernel.cluster_launches = 0


def _recompute_gates(xg, lens, w_hf, w_hb, y):
    """The gate activations [B,T,8H] f32 that the TPU backward kernel forms
    for bf16 projections with an f32 compute dtype: from the projections
    xg = (xg_f, xg_b) and the rounded h stream y, through one f32 product a
    direction (``csrc/bilstm_bwd.cu::bilstm_v1_gates``). The forward's
    activations took the unrounded h in its f32 product: not these."""
    B, T, H2 = y.shape
    H = H2 // 2
    dev = y.device
    if xg is None:
        raise ValueError("bf16 projections with an f32 compute dtype need "
                         "xg=(xg_f, xg_b): the backward recomputes the gates")
    for name, t in zip(("xg_f", "xg_b"), xg):
        _check(t, name, torch.bfloat16, (B, T, 4 * H), dev)
    wf, wb = (w.to(torch.float32).contiguous() for w in (w_hf, w_hb))
    acts = torch.empty(B, T, 8 * H, device=dev, dtype=torch.float32)
    _launch("bilstm_bwd", "bilstm_v1_gates", dev, (
        xg[0].data_ptr(), xg[1].data_ptr(), lens.data_ptr(), wf.data_ptr(),
        wb.data_ptr(), y.data_ptr(), acts.data_ptr(), B, T, H),
        f"B={B} T={T} H={H}")
    return acts


def bilstm_pallas_bwd_kernel(lens, w_hf, w_hb, y, c, acts, dy,
                             compute_dtype: torch.dtype = torch.float32,
                             x_dtype: torch.dtype = torch.float32, xg=None):
    """K7-bwd on the card: the VJP from the training form of K7-fwd's
    outputs (y, c, acts of ``bilstm_pallas_kernel(..., with_cell=True)``)
    and the cotangent dy [B,T,2H]. Returns (dxg_f, dxg_b) in ``x_dtype``
    (xg's) and (dw_hf, dw_hb) in W's dtype, summed in f32. For bf16
    projections with an f32 compute dtype it recomputes the gates from the
    rounded h stream first, as the TPU kernel does (``_recompute_gates``;
    ``xg``, the pair (xg_f, xg_b), is then required and ``acts`` unused);
    ``.gate_launches`` counts those recomputes."""
    B, T, H2 = y.shape
    H = H2 // 2
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"bilstm_pallas_bwd_kernel needs CUDA tensors, got {dev}")
    if compute_dtype not in _STREAM_DTYPES or w_hf.dtype not in _STREAM_DTYPES:
        raise ValueError(f"compute_dtype and W_h must be float32 or bfloat16, "
                         f"got {compute_dtype}, {w_hf.dtype}")
    if not 0 < H <= MAX_HIDDEN:
        raise ValueError(f"hidden size {H} outside the kernel's 1..{MAX_HIDDEN}")
    _check(lens, "lens", torch.int32, (B,), dev)
    _check(w_hf, "w_hf", w_hf.dtype, (H, 4 * H), dev)
    _check(w_hb, "w_hb", w_hf.dtype, (H, 4 * H), dev)
    _check(y, "y", torch.float32, (B, T, 2 * H), dev)
    _check(c, "c", torch.float32, (B, T, 2 * H), dev)
    _check(acts, "acts", torch.float32, (B, T, 8 * H), dev)
    if dy.shape != y.shape or dy.device != dev:
        raise ValueError(f"dy must be {tuple(y.shape)} on {dev}, "
                         f"got {tuple(dy.shape)} on {dy.device}")
    f32 = dict(device=dev, dtype=torch.float32)
    alloc = torch.empty if B and T else torch.zeros  # the kernel fills them
    dg = alloc(B, T, 8 * H, **f32)
    dw_hf = alloc(H, 4 * H, **f32)
    dw_hb = alloc(H, 4 * H, **f32)
    if B and T:
        dy = dy.to(torch.float32).contiguous()
        wtf, wtb, cluster = _bwd_weights(w_hf, w_hb, compute_dtype)
        bf16 = compute_dtype == torch.bfloat16
        if x_dtype == torch.bfloat16 and not bf16:
            acts = _recompute_gates(xg, lens, w_hf, w_hb, y)
            bilstm_pallas_bwd_kernel.gate_launches += 1
        yh, yb = _h_rows(y) if bf16 else (y, H)
        ws, ws_ptr = _products_workspace(dev, B, T, 0, H, False, bf16)
        _launch("bilstm_bwd", "bilstm_v1_bwd", dev, (
            lens.data_ptr(), wtf.data_ptr(), wtb.data_ptr(), yh.data_ptr(),
            c.data_ptr(), acts.data_ptr(), dy.data_ptr(), dg.data_ptr(),
            dw_hf.data_ptr(), dw_hb.data_ptr(), ws_ptr, B, T, H,
            yh.shape[-1], yb, int(bf16)),
            f"B={B} T={T} H={H}")
        bilstm_pallas_bwd_kernel.launches += 1
        bilstm_pallas_bwd_kernel.cluster_launches += cluster
    return (dg[..., :4 * H].to(x_dtype), dg[..., 4 * H:].to(x_dtype),
            dw_hf.to(w_hf.dtype), dw_hb.to(w_hb.dtype))


bilstm_pallas_bwd_kernel.launches = 0
bilstm_pallas_bwd_kernel.cluster_launches = 0
bilstm_pallas_bwd_kernel.gate_launches = 0


class BiLSTMV1(torch.autograd.Function):
    """``bilstm_pallas`` with its gradient: the plain forward and backward
    for CPU tensors, K7-fwd (training form) and K7-bwd for CUDA tensors.
    lens and compute_dtype get no gradient."""

    @staticmethod
    def forward(ctx, xg_f, xg_b, lens, w_hf, w_hb, compute_dtype):
        args = (xg_f, xg_b, lens, w_hf, w_hb, compute_dtype)
        if _route(xg_f) == "plain":
            (y, c), acts = bilstm_pallas_plain(*args, with_cell=True), None
            out = y
        else:
            y, c, acts = bilstm_pallas_kernel(*args, with_cell=True)
            out = y.to(xg_f.dtype)
        ctx.save_for_backward(xg_f, xg_b, lens, w_hf, w_hb, y, c, acts)
        ctx.compute_dtype = compute_dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        xg_f, xg_b, lens, w_hf, w_hb, y, c, acts = ctx.saved_tensors
        if _route(xg_f) == "plain":
            grads = bilstm_pallas_bwd_plain(xg_f, xg_b, lens, w_hf, w_hb, y,
                                            c, dy, ctx.compute_dtype)
        else:
            grads = bilstm_pallas_bwd_kernel(lens, w_hf, w_hb, y, c, acts, dy,
                                             ctx.compute_dtype, xg_f.dtype,
                                             (xg_f, xg_b))
        dxg_f, dxg_b, dw_hf, dw_hb = grads
        return dxg_f, dxg_b, None, dw_hf, dw_hb, None


def bilstm_pallas(xg_f, xg_b, lens, w_hf, w_hb,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The v1 BiLSTM layer (``pallas_lstm.py::bilstm_pallas``): the plain
    version for CPU tensors, K7 for CUDA tensors; through ``BiLSTMV1``
    when a gradient is wanted. Returns [B,T,2H] in xg's dtype."""
    route = _route(xg_f)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xg_f, xg_b, w_hf, w_hb)):
        return BiLSTMV1.apply(xg_f, xg_b, lens, w_hf, w_hb, compute_dtype)
    if route == "plain":
        return bilstm_pallas_plain(xg_f, xg_b, lens, w_hf, w_hb, compute_dtype)
    return bilstm_pallas_kernel(xg_f, xg_b, lens, w_hf, w_hb, compute_dtype)
