"""PyTorch port on the card: P1's two kernels (csrc/pipeline_probe.cu)
against the plain version at the TPU probe's T=640, M=96 and a ragged
M=100, one and four chains, and the wrapper's refusals on the card.

Marked ``cuda``: these skip where there is no CUDA device. On a machine
with the card and nvcc, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_probe.py``.
Tolerance 1e-4 max abs, chip_smoke.py's f32 K1 tolerance: only the order
of the f32 sums differs, carried over 640 steps. The inputs keep the
state alive for all the steps (``live_inputs``), so the comparison is not
one of zeros.
"""

import pytest
import torch

from gluon_e2e_asr_tpu_torch.tools import pipeline_probe as P

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("variant", P.VARIANTS)
@pytest.mark.parametrize("N", [1, 4])
@pytest.mark.parametrize("M", [96, 100])
def test_kernel_matches_plain(dev, variant, N, M):
    h0, c0, w = P.live_inputs(N, M, dev, seed=M + N)
    kernel = P.KERNELS[variant]
    launches, calls = kernel.launches, P.pipeline_probe_plain.calls
    got = P.pipeline_probe(h0, c0, w, 640, variant)
    assert kernel.launches == launches + 1
    assert P.pipeline_probe_plain.calls == calls  # a CUDA tensor never takes it
    ref = P.pipeline_probe_plain(h0, c0, w, 640)
    torch.cuda.synchronize()
    assert float(ref.abs().mean()) > 0.1
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= TOL


@pytest.mark.parametrize("variant", P.VARIANTS)
def test_small_ragged_shape_and_no_steps(dev, variant):
    h0, c0, w = P.live_inputs(3, 37, dev, seed=1)
    got = P.pipeline_probe(h0, c0, w, 9, variant)
    ref = P.pipeline_probe_plain(h0, c0, w, 9)
    assert float((got - ref).abs().max()) <= TOL
    assert torch.equal(P.pipeline_probe(h0, c0, w, 0, variant), h0)


def test_the_card_holds_a_cluster(dev):
    assert P.max_active_clusters(dev) >= 1


def test_refusals_on_the_card(dev):
    h0, c0, w = P.probe_inputs(2, 8, dev)
    calls = P.pipeline_probe_plain.calls
    with pytest.raises(ValueError, match="float32"):
        P.pipeline_probe(h0.double(), c0, w, 4, "cluster")
    with pytest.raises(ValueError, match="is on"):
        P.pipeline_probe(h0, c0.cpu(), w, 4)
    with pytest.raises(ValueError, match="contiguous"):
        P.pipeline_probe(h0, c0, w.transpose(1, 2).contiguous().transpose(1, 2),
                         4, "l2")
    with pytest.raises(ValueError, match="at most 4 chains"):
        P.pipeline_probe(*P.probe_inputs(5, 8, dev), 4, "l2")
    assert P.pipeline_probe_plain.calls == calls
