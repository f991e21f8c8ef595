"""PyTorch port on the card: a training step is a function of its inputs.

K1-bwd's products (``csrc/bilstm_bwd.cu``: ``wgrad_kernel`` in bf16,
``ring_kernel`` in f32, their splits' parts summed in a fixed order by
``csrc/split_sum.cuh``), K1-bwd and K7-bwd whole and the CTC loss's
gradient, each launched three times on identical inputs: every output
``torch.equal`` to the first launch's. Then two runs of a few training
steps of the tiny golden config (hybrid, add attention; with loc
attention, a stacked decoder, gradient accumulation, encoder dropout)
from the same seed: every
parameter, gradient, optimizer slot and the generator state equal bit
for bit (``chip_smoke.py``'s phase 6e does the same at the configs'
widths).

Marked ``cuda``: these skip where there is no CUDA device. On a machine
with the card and nvcc, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_repro.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.ops import bilstm as K
from gluon_e2e_asr_tpu_torch.ops import ctc as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

TINY = os.path.join(REPO, "tests", "goldens", "tiny_golden.yaml")
# (B, T, D, H): ragged, the milestones' layers 0 and 1 (f32 splits dx by
# 10 and 2, dW_x by 16 and 2, dW_h by 8), the flagship's layer 1 (bf16: 2
# splits)
SHAPES = [(3, 19, 12, 8), (16, 398, 80, 256), (16, 199, 1024, 256),
          (96, 199, 1280, 320)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _same_thrice(call):
    outs = [[t.clone() for t in chip_smoke.tensors_of(call())]
            for _ in range(3)]
    torch.cuda.synchronize()
    return all(len(o) == len(outs[0])
               and all(torch.equal(a, b) for a, b in zip(o, outs[0]))
               for o in outs[1:])


def _layer(B, T, D, H, dev, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    arrays = (rng.randn(B, T, D).astype(np.float32), lens,
              (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32),
              (rng.randn(8 * H) * 0.1).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))
    dy = rng.randn(B, T, 2 * H).astype(np.float32)
    return (tuple(torch.from_numpy(a).to(dev) for a in arrays),
            torch.from_numpy(dy).to(dev))


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", SHAPES)
def test_k1_bwd_and_its_products_repeat_bit_for_bit(dev, cd, B, T, D, H):
    args, dy = _layer(B, T, D, H, dev)
    x, lens, w_x, b_x, w_hf, w_hb = args
    y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd, with_cell=True)
    dg = K.bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, c, acts, dy, cd)
    assert _same_thrice(lambda: K.bilstm_fused_bwd_products_kernel(
        x, lens, w_x, y, dg, cd))
    assert _same_thrice(lambda: K.bilstm_fused_bwd_kernel(
        x, lens, w_x, w_hf, w_hb, y, c, acts, dy, compute_dtype=cd))


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_k7_bwd_repeats_bit_for_bit(dev, cd):
    (x, lens, w_x, b_x, w_hf, w_hb), dy = _layer(16, 199, 64, 256, dev)
    xg = torch.matmul(x, w_x) + b_x
    xg_f, xg_b = (xg[..., :1024].contiguous().to(cd),
                  xg[..., 1024:].contiguous().to(cd))
    y, c, acts = K.bilstm_pallas_kernel(xg_f, xg_b, lens, w_hf, w_hb, cd,
                                        with_cell=True)
    assert _same_thrice(lambda: K.bilstm_pallas_bwd_kernel(
        lens, w_hf, w_hb, y, c, acts, dy.to(cd), cd, cd))


def test_ctc_gradient_repeats_bit_for_bit(dev):
    """The CTC loss's backward on the card (K3, then the posterior's
    one-hot product over the vocabulary; a scatter-add there added
    atomically, in an order that varied)."""
    rng = np.random.RandomState(0)
    B, T, L, V = 32, 100, 40, 31
    logits = torch.from_numpy(rng.randn(B, T, V).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.randint(1, V, size=(B, L)).astype(np.int32))
    label_lens = torch.from_numpy(rng.randint(1, L + 1, size=B).astype(np.int32))
    labels = (labels * (torch.arange(L)[None] < label_lens[:, None])).to(dev)
    input_lens = torch.full((B,), T, dtype=torch.int32, device=dev)

    def grad():
        lg = logits.clone().requires_grad_(True)
        C.ctc_loss(lg, input_lens, labels, label_lens.to(dev)).sum().backward()
        return lg.grad

    assert _same_thrice(grad)


@pytest.mark.parametrize("sets", [(), ("model.att_type=loc",),
                                  ("model.dec_layers=2",),
                                  ("train.accum_grad_steps=2",),
                                  ("model.enc_dropout=0.1",)])
def test_two_training_runs_end_bit_equal(dev, sets):
    config = load_config(TINY)
    apply_overrides(config, list(sets))
    batch, tok = chip_smoke.repro_batch(torch, TINY, "bucket")
    runs = [chip_smoke.repro_run(torch, config, tok, batch, dev, 3)
            for _ in range(2)]
    diff = chip_smoke.state_diff(torch, *runs)
    assert diff["equal"], diff
