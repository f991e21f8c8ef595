"""LSTM primitives as a torch time loop.

Counterpart of ``gluon_e2e_asr_tpu/models/lstm.py``. The input projection
for all timesteps is computed outside the loop; the loop carries only the
recurrent [B, H] @ [H, 4H] update. Gate order (i, f, g, o), forget bias
+1 inside the cell. Padded steps emit zeros and hold (h, c), which lets
the backward direction start from zero state at each row's last valid
frame. This loop is the plain version of the fused BiLSTM kernel
(``ops/bilstm.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def work_dtype(*ts: torch.Tensor) -> torch.dtype:
    """f64 where an input is f64 (gradient checks), else f32."""
    return torch.float64 if any(t.dtype == torch.float64 for t in ts) \
        else torch.float32


def matmul_cd(a: torch.Tensor, b: torch.Tensor,
              compute_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with the inputs rounded to ``compute_dtype`` and the sum
    kept in f32 (JAX's ``preferred_element_type=float32``). A product of
    two bf16 values is exact in f32, so rounding the operands and
    multiplying in f32 is the bf16 matmul with f32 accumulation. f64
    inputs with an f32 ``compute_dtype`` stay f64."""
    work = work_dtype(a, b)
    if compute_dtype not in (torch.float32, torch.float64):
        a = a.to(compute_dtype)
        b = b.to(compute_dtype)
    return torch.matmul(a.to(work), b.to(work))


def lstm_cell_step(
    h: torch.Tensor,  # [..., B, H]
    c: torch.Tensor,  # [..., B, H]
    x_gates: torch.Tensor,  # [..., B, 4H] = x_t @ W_x + b (precomputed)
    w_h: torch.Tensor,  # [..., H, 4H]
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM cell update. Gate order: (i, f, g, o); forget bias +1."""
    gates = x_gates + matmul_cd(h, w_h, compute_dtype)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def bilstm_scan(
    x_gates_f: torch.Tensor,  # [B, T, 4H] forward-direction projections
    x_gates_b: torch.Tensor,  # [B, T, 4H] backward-direction projections
    lens: torch.Tensor,  # [B]
    w_hf: torch.Tensor,  # [H, 4H]
    w_hb: torch.Tensor,  # [H, 4H]
    compute_dtype: torch.dtype = torch.float32,
    with_cell: bool = False,
):
    """Both directions in one time loop over a stacked [2, B, H] state;
    the backward direction consumes time-flipped inputs. Returns
    concat(fwd, bwd) outputs [B, T, 2H] f32 (f64 for f64 inputs), and
    with ``with_cell`` also the c streams in the same layout, zero past
    ``lens`` like the outputs."""
    B, T, H4 = x_gates_f.shape
    H = H4 // 4
    dev = x_gates_f.device
    work = work_dtype(x_gates_f, w_hf)
    valid = torch.arange(T, device=dev)[None, :] < lens.to(dev)[:, None]
    xs = torch.stack([x_gates_f.transpose(0, 1),
                      x_gates_b.flip(1).transpose(0, 1)], dim=1).to(work)
    vs = torch.stack([valid.T, valid.flip(1).T], dim=1)  # [T, 2, B]
    w = torch.stack([w_hf, w_hb])  # [2, H, 4H]
    h = torch.zeros(2, B, H, device=dev, dtype=work)
    c = torch.zeros(2, B, H, device=dev, dtype=work)
    ys, cs = [], []
    for t in range(T):
        h_new, c_new = lstm_cell_step(h, c, xs[t], w, compute_dtype)
        vm = vs[t][..., None]
        h = torch.where(vm, h_new, h)
        c = torch.where(vm, c_new, c)
        ys.append(torch.where(vm, h_new, torch.zeros_like(h_new)))
        cs.append(torch.where(vm, c_new, torch.zeros_like(c_new)))

    def streams(seq):  # [T, 2, B, H] -> concat(fwd, bwd) [B, T, 2H]
        s = torch.stack(seq)
        return torch.cat([s[:, 0].transpose(0, 1),
                          s[:, 1].flip(0).transpose(0, 1)], dim=-1)

    if with_cell:
        return streams(ys), streams(cs)
    return streams(ys)
