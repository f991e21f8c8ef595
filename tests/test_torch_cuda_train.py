"""PyTorch port on the card: the training kernels against their plain
versions at small, ragged shapes. K1-fwd's training form
(csrc/bilstm_fwd.cu with a c output), K1-bwd (csrc/bilstm_bwd.cu), and
K2/K3 (csrc/ctc.cu); then the CTC loss and the BiLSTM gradient on the
card against the same functions on the CPU; K1 at the VGG2L front's
width (D = 2560); and a stacked decoder's train step, which launches no
K4.

Marked ``cuda``: these skip where there is no CUDA device. On a machine
with the card and nvcc, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py``.

Tolerances. f32: only the order of the sums differs (the weight
gradients add split-K partial sums atomically), 1e-4 of the largest
magnitude. bf16: the kernel reads the gate activations K1-fwd saved
while the plain version recomputes them, so a bf16 rounding of dg can
flip and travel through the reverse recursion: 2e-2 of the largest
magnitude. CTC: exact expf/logf on both sides, 1e-5 relative.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


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


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


SHAPES = [(3, 19, 12, 8), (4, 33, 80, 40), (2, 9, 64, 320)]


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", SHAPES)
def test_training_forward_matches_plain(dev, cd, B, T, D, H):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    args, _ = _layer(B, T, D, H, dev)
    y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd, with_cell=True)
    yp, cp = K.bilstm_fused_plain(*args, compute_dtype=cd, with_cell=True)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= REL[cd] and _rel(c, cp) <= REL[cd]
    lens = args[1].long()
    for b in range(B):  # zero past lens, like the h stream
        assert not c[b, lens[b]:].any() and not acts[b, lens[b]:].any()
    assert torch.equal(y, K.bilstm_fused_kernel(*args, compute_dtype=cd))


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", SHAPES)
def test_backward_kernel_matches_plain(dev, cd, B, T, D, H):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    args, dy = _layer(B, T, D, H, dev, seed=1)
    x, lens, w_x, b_x, w_hf, w_hb = args
    y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd, with_cell=True)
    got = K.bilstm_fused_bwd_kernel(x, lens, w_x, w_hf, w_hb, y, c, acts, dy,
                                    compute_dtype=cd)
    ref = K.bilstm_fused_bwd_plain(x, lens, w_x, b_x, w_hf, w_hb, y, c, dy,
                                   compute_dtype=cd)
    torch.cuda.synchronize()
    for name, g, r in zip(("dx", "dw_x", "db", "dw_hf", "dw_hb"), got, ref):
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= REL[cd], (name, _rel(g, r))


def test_autograd_on_card_matches_cpu(dev):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    args, dy = _layer(3, 19, 12, 8, dev, seed=2)
    grads = {}
    for d in (dev, torch.device("cpu")):
        ins = [a.to(d).clone() for a in args]
        for i in (0, 2, 3, 4, 5):
            ins[i].requires_grad_(True)
        launches = K.bilstm_fused_bwd_kernel.launches
        y = K.bilstm_fused(*ins)
        (y * dy.to(d)).sum().backward()
        assert K.bilstm_fused_bwd_kernel.launches == launches + (d.type == "cuda")
        grads[d.type] = [ins[i].grad.cpu() for i in (0, 2, 3, 4, 5)]
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert _rel(g, r) <= REL[torch.float32]


def _ctc_case(dev, T=23, B=5, L=6, V=11, seed=0):
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(B, T, V).astype(np.float32) * 2)
    labels = torch.from_numpy(rng.randint(1, 4, size=(B, L)).astype(np.int32))
    label_lens = torch.tensor([L, 3, 0, L, 2], dtype=torch.int32)[:B]
    input_lens = torch.tensor([T, 11, 7, 4, 0], dtype=torch.int32)[:B]
    logp = torch.log_softmax(logits, -1)
    ext, skip, svalid, tmask = C._lattice(T, input_lens, labels, label_lens, 0)
    emit = C._gather_states(logp, ext)
    return [t.to(dev) for t in (emit, tmask, skip, svalid, label_lens)], (
        logits, input_lens, labels, label_lens)


def test_alpha_and_beta_post_kernels_match_plain(dev):
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    (emit, tmask, skip, svalid, label_lens), _ = _ctc_case(dev)
    alpha = C.ctc_alpha_kernel(emit, tmask, skip, svalid)
    alpha_p = C._alpha_plain(emit, tmask, skip, svalid)
    torch.testing.assert_close(alpha, alpha_p, rtol=1e-5, atol=1e-4)
    ll = C._log_likelihood(alpha_p, label_lens)
    post = C.ctc_beta_post_kernel(emit, tmask, skip, svalid, 2 * label_lens,
                                  alpha_p, ll)
    post_p = C._beta_post_plain(emit, tmask, skip, svalid, 2 * label_lens,
                                alpha_p, ll)
    torch.testing.assert_close(post, post_p, rtol=1e-5, atol=1e-6)


def test_ctc_loss_on_card_matches_cpu(dev):
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    _, (logits, input_lens, labels, label_lens) = _ctc_case(dev, seed=3)
    out = {}
    for d in (dev, torch.device("cpu")):
        lg = logits.to(d).clone().requires_grad_(True)
        nll = C.ctc_loss(lg, input_lens.to(d), labels.to(d), label_lens.to(d))
        nll.sum().backward()
        out[d.type] = (nll.detach().cpu(), lg.grad.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5, atol=1e-5)


def test_alpha_kernel_refuses_too_many_states(dev):
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    T, B, S = 4, 2, C.MAX_STATES + 1
    emit = torch.zeros(T, B, S, device=dev)
    masks = (torch.ones(T, B, dtype=torch.bool, device=dev),
             torch.zeros(B, S, dtype=torch.bool, device=dev),
             torch.ones(B, S, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="lattice states"):
        C.ctc_alpha(emit, *masks)


# K1 at vgg_blstm.yaml's layer-0 reduction width: VGG2L's 128 channels of
# 20 mel bins, D = 2560, where every other config feeds K1 80 to 640.
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_k1_at_the_vgg_front_width_matches_plain(dev, cd):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    args, dy = _layer(8, 25, 2560, 320, dev, seed=4)
    x, lens, w_x, b_x, w_hf, w_hb = args
    n = K.bilstm_fused_kernel.cluster_launches
    y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd, with_cell=True)
    yp, cp = K.bilstm_fused_plain(*args, compute_dtype=cd, with_cell=True)
    got = K.bilstm_fused_bwd_kernel(x, lens, w_x, w_hf, w_hb, y, c, acts, dy,
                                    compute_dtype=cd)
    ref = K.bilstm_fused_bwd_plain(x, lens, w_x, b_x, w_hf, w_hb, y, c, dy,
                                   compute_dtype=cd)
    torch.cuda.synchronize()
    assert K.bilstm_fused_kernel.cluster_launches == n + 1
    assert _rel(y, yp) <= REL[cd] and _rel(c, cp) <= REL[cd]
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all() and _rel(g, r) <= REL[cd]


def test_stacked_decoder_step_launches_no_k4(dev):
    """A hybrid train step with dec_layers=2 on the card: K1, K2 and K3
    launch, K4 does not (the stacked decoder is plain torch, the JAX route
    for it), and the loss equals the same step's on the CPU."""
    from gluon_e2e_asr_tpu_torch.config import Config, ModelConfig
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.ops import bilstm, ctc
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD
    from gluon_e2e_asr_tpu_torch.training import train_step as T

    config = Config()
    config.model = ModelConfig(enc_hidden=16, enc_layers=2, enc_subsample=(1, 2),
                               dec_hidden=16, dec_embed=8, att_dim=8,
                               dec_layers=2, att_type="loc",
                               loc_conv_channels=3, loc_conv_width=5)
    config.loss.mtl_alpha, config.loss.scheduled_sampling = 0.3, 0.0
    config.frontend.specaug_freq_masks = config.frontend.specaug_time_masks = 0
    rng = np.random.RandomState(0)
    batch = {"audio": torch.from_numpy((rng.randn(3, 8000) * 0.1).astype(np.float32)),
             "audio_len": torch.tensor([8000, 6000, 3000], dtype=torch.int32),
             "labels": torch.from_numpy(rng.randint(4, 11, (3, 5)).astype(np.int32)),
             "label_len": torch.tensor([5, 4, 2], dtype=torch.int32)}
    losses = {}
    for d in (dev, torch.device("cpu")):
        model = build_model(config, 11, train=True)
        opt = T.make_optimizer(config)
        state = T.create_train_state(config, model, opt, d)
        counts = [f.launches for f in (LD.las_decoder_fwd_kernel,
                                       LD.las_decoder_bwd_kernel,
                                       bilstm.bilstm_fused_bwd_kernel,
                                       ctc.ctc_alpha_kernel)]
        m = T.make_train_step(model, config, opt)(state, batch)
        after = [f.launches for f in (LD.las_decoder_fwd_kernel,
                                      LD.las_decoder_bwd_kernel,
                                      bilstm.bilstm_fused_bwd_kernel,
                                      ctc.ctc_alpha_kernel)]
        moved = [a - b for a, b in zip(after, counts)]
        assert moved == ([0, 0, 2, 1] if d.type == "cuda" else [0, 0, 0, 0])
        losses[d.type] = float(m["loss"])
    assert np.isfinite(losses["cuda"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])


def test_checkpoint_holds_global_cmvn_stats_from_the_card(dev, tmp_path):
    """The trainer keeps global CMVN stats on its device: a checkpoint
    stores them on the host and restores them unchanged."""
    from gluon_e2e_asr_tpu_torch.training.checkpoint import (
        restore_checkpoint, save_checkpoint)

    stats = (torch.randn(80, device=dev), torch.rand(80, device=dev) + 0.5)
    path = save_checkpoint(str(tmp_path / "c.pt"),
                           {"w": torch.ones(3, device=dev)}, {}, stats)
    _, cmvn, _ = restore_checkpoint(path)
    for got, want in zip(cmvn, stats):
        assert got.device.type == "cpu"
        torch.testing.assert_close(got, want.cpu(), rtol=0, atol=0)
