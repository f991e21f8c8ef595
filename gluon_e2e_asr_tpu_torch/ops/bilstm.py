"""One BiLSTM layer with the input projection fused: K1-fwd.

Counterpart of ``gluon_e2e_asr_tpu/ops/pallas_lstm.py::bilstm_fused``
(forward). Two versions of one function:

- ``bilstm_fused_plain``: plain PyTorch (a projection matmul and the
  time loop of ``models/lstm.py``). The CPU path, and the reference the
  kernel is held against on the card.
- ``bilstm_fused_kernel``: the hand-written Hopper kernel in
  ``csrc/bilstm_fwd.cu``. That file's header names the TPU kernel it
  replaces, what bounds it on the card and what its design does about
  it.

``bilstm_fused`` dispatches on the device of ``x``: the plain version
for a CPU tensor, the kernel for a CUDA tensor, and nothing else. No
path falls back from the kernel to the plain version.

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
from gluon_e2e_asr_tpu_torch.models.lstm import bilstm_scan, matmul_cd

MAX_HIDDEN = 1024  # one thread per hidden unit in the recurrence kernel


def bilstm_fused_plain(x, lens, w_x, b_x, w_hf, w_hb,
                       compute_dtype: torch.dtype = torch.float32,
                       round_xg: bool = False) -> torch.Tensor:
    """x [B,T,D]; lens [B]; w_x [D,8H] (forward gates, then backward);
    b_x [8H]; w_hf/w_hb [H,4H]. Returns concat(fwd, bwd) [B,T,2H] f32,
    zero at t >= lens[b]."""
    bilstm_fused_plain.calls += 1
    T = x.shape[1]
    H = w_hf.shape[0]
    xg = matmul_cd(x, w_x, compute_dtype) + b_x.float()
    valid = torch.arange(T, device=x.device)[None, :] < lens[:, None]
    xg_b = xg[..., 4 * H:] * valid[..., None]
    xg_f = xg[..., :4 * H]
    if round_xg:
        xg_f = xg_f.to(compute_dtype).float()
        xg_b = xg_b.to(compute_dtype).float()
    return bilstm_scan(xg_f, xg_b, lens, w_hf, w_hb, compute_dtype)


bilstm_fused_plain.calls = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("bilstm_fwd")
    if lib.bilstm_fwd.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        lib.bilstm_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.bilstm_fwd.restype = ctypes.c_int
        lib.bilstm_error_string.argtypes = [ctypes.c_int]
        lib.bilstm_error_string.restype = ctypes.c_char_p
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


def _interleave_gates(w_h: torch.Tensor) -> torch.Tensor:
    """[H, 4H] gate-major (i|f|g|o) -> [H, 4H] with column 4u+g holding
    gate g of unit u."""
    H = w_h.shape[0]
    return w_h.reshape(H, 4, H).transpose(1, 2).reshape(H, 4 * H).contiguous()


def bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb,
                        compute_dtype: torch.dtype = torch.float32,
                        round_xg: bool = False) -> torch.Tensor:
    """K1-fwd on the card. Same contract as ``bilstm_fused_plain``; x,
    w_x, b_x, w_hf, w_hb f32 and lens int32, all contiguous on one CUDA
    device."""
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_fused_kernel needs CUDA tensors, got {x.device}")
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
    _check(b_x, "b_x", torch.float32, (8 * H,), dev)
    _check(w_hf, "w_hf", torch.float32, (H, 4 * H), dev)
    _check(w_hb, "w_hb", torch.float32, (H, 4 * H), dev)
    y = torch.empty(B, T, 2 * H, device=dev, dtype=torch.float32)
    if B == 0 or T == 0:
        return y
    # The recurrent weights are read from L2 every step: ship them in the
    # compute dtype (the TPU wrapper casts them the same way), with each
    # hidden unit's four gate columns adjacent (one vector load).
    whf = _interleave_gates(w_hf).to(compute_dtype)
    whb = _interleave_gates(w_hb).to(compute_dtype)
    xg = torch.empty(B, T, 8 * H, device=dev, dtype=torch.float32)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.bilstm_fwd(
            x.data_ptr(), lens.data_ptr(), w_x.data_ptr(), b_x.data_ptr(),
            whf.data_ptr(), whb.data_ptr(), xg.data_ptr(), y.data_ptr(),
            B, T, D, H, int(compute_dtype == torch.bfloat16), int(round_xg),
            stream)
    if rc != 0:
        raise RuntimeError(
            f"bilstm_fwd launch failed: {lib.bilstm_error_string(rc).decode()} "
            f"(B={B} T={T} D={D} H={H})")
    bilstm_fused_kernel.launches += 1
    return y


bilstm_fused_kernel.launches = 0


def bilstm_fused(x, lens, w_x, b_x, w_hf, w_hb,
                 compute_dtype: torch.dtype = torch.float32,
                 round_xg: bool = False) -> torch.Tensor:
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return bilstm_fused_plain(x, lens, w_x, b_x, w_hf, w_hb,
                                  compute_dtype, round_xg)
    if x.device.type == "cuda":
        return bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb,
                                   compute_dtype, round_xg)
    raise ValueError(f"bilstm_fused: no implementation for device {x.device}")
