"""PyTorch port on the card: the K1-fwd kernel (csrc/bilstm_fwd.cu)
against its plain version at small, ragged shapes, and the encoder on
the card against the encoder on the CPU.

Marked ``cuda``: these skip where there is no CUDA device. On a machine
with the card and nvcc, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_bilstm.py``
(the repository's conftest imports jax, which the port does not need).
Tolerances as in chip_smoke.py: f32 sums in another order, bf16 may
flip one rounding of h.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(B, T, D, H, dev, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    arrays = (rng.randn(B, T, D).astype(np.float32), lens,
              (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32),
              (rng.randn(8 * H) * 0.1).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


@pytest.mark.parametrize("round_xg", [False, True])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 19, 12, 8), (5, 37, 33, 40),
                                   (9, 50, 130, 130)])
def test_kernel_matches_plain(dev, shape, cd, round_xg):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    args = _inputs(*shape, dev)
    y = K.bilstm_fused_kernel(*args, compute_dtype=cd, round_xg=round_xg)
    ref = K.bilstm_fused_plain(*args, compute_dtype=cd, round_xg=round_xg)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    assert float((y - ref).abs().max()) <= TOL[cd]


def test_kernel_wrapper_checks_its_inputs(dev):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    x, lens, w_x, b_x, w_hf, w_hb = _inputs(3, 19, 12, 8, dev)
    with pytest.raises(ValueError, match="contiguous"):
        K.bilstm_fused_kernel(x.transpose(0, 1).contiguous().transpose(0, 1),
                              lens, w_x, b_x, w_hf, w_hb)
    with pytest.raises(ValueError, match="int32"):
        K.bilstm_fused_kernel(x, lens.long(), w_x, b_x, w_hf, w_hb)
    with pytest.raises(ValueError, match="hidden size"):
        big = torch.zeros(1025, 4 * 1025, device=dev)
        K.bilstm_fused_kernel(x, lens, w_x, b_x, big, big)


def test_encoder_on_card_matches_cpu(dev):
    from gluon_e2e_asr_tpu_torch.config import ModelConfig
    from gluon_e2e_asr_tpu_torch.models.asr import ASRModel
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    cfg = ModelConfig(enc_hidden=32, enc_layers=3, enc_subsample=(1, 2, 2),
                      lstm_impl="pallas", compute_dtype="float32")
    model = ASRModel(cfg, 12, 20)
    model.encoder.reset_parameters(torch.Generator().manual_seed(0))
    feats = torch.randn(4, 41, 20, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([41, 30, 7, 1], dtype=torch.int32)
    launches = K.bilstm_fused_kernel.launches
    with torch.inference_mode():
        ref = model.encode(feats, lens)
        got = model.to(dev).encode(feats.to(dev), lens.to(dev))
    assert K.bilstm_fused_kernel.launches == launches + 3
    for r, g in zip(ref, got):
        assert float((g.cpu().float() - r.float()).abs().max()) <= 1e-5
