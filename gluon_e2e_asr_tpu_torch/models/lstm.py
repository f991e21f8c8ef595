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


def matmul_cd(a: torch.Tensor, b: torch.Tensor,
              compute_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` with the inputs rounded to ``compute_dtype`` and the sum
    kept in f32 (JAX's ``preferred_element_type=float32``). A product of
    two bf16 values is exact in f32, so rounding the operands and
    multiplying in f32 is the bf16 matmul with f32 accumulation."""
    if compute_dtype != torch.float32:
        a = a.to(compute_dtype).float()
        b = b.to(compute_dtype).float()
    return torch.matmul(a.float(), b.float())


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
) -> torch.Tensor:
    """Both directions in one time loop over a stacked [2, B, H] state;
    the backward direction consumes time-flipped inputs. Returns
    concat(fwd, bwd) outputs [B, T, 2H] f32."""
    B, T, H4 = x_gates_f.shape
    H = H4 // 4
    dev = x_gates_f.device
    valid = torch.arange(T, device=dev)[None, :] < lens.to(dev)[:, None]
    xs = torch.stack([x_gates_f.transpose(0, 1),
                      x_gates_b.flip(1).transpose(0, 1)], dim=1).float()
    vs = torch.stack([valid.T, valid.flip(1).T], dim=1)  # [T, 2, B]
    w = torch.stack([w_hf, w_hb])  # [2, H, 4H]
    h = torch.zeros(2, B, H, device=dev)
    c = torch.zeros(2, B, H, device=dev)
    ys = []
    for t in range(T):
        h_new, c_new = lstm_cell_step(h, c, xs[t], w, compute_dtype)
        vm = vs[t][..., None]
        h = torch.where(vm, h_new, h)
        c = torch.where(vm, c_new, c)
        ys.append(torch.where(vm, h_new, torch.zeros_like(h_new)))
    y = torch.stack(ys)  # [T, 2, B, H]
    fwd = y[:, 0].transpose(0, 1)
    bwd = y[:, 1].flip(0).transpose(0, 1)
    return torch.cat([fwd, bwd], dim=-1)
