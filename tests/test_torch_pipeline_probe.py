"""PyTorch port: P1, the pipelining probe
(``gluon_e2e_asr_tpu_torch/tools/pipeline_probe.py``), on the CPU, where
it runs its plain version, against the JAX package's
``tools/pipeline_probe.py::make_probe`` run in interpret mode.

``make_probe`` returns a jitted function of the output's sum. Here
``pallas_call`` is wrapped to run in interpret mode and to record the
kernel's output, and ``jax.jit`` is the identity while ``make_probe``
builds the function, so the recorded output is the concrete [N,M,320]
array, compared per chain and per unit. Tolerance rtol/atol 1e-5 in f32,
the JAX suite's own for the LSTM kernels against their scan paths.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gluon_e2e_asr_tpu_torch.tools import pipeline_probe as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = P.H

torch.set_num_threads(1)


def _tpu_probe(monkeypatch):
    """tools/pipeline_probe.py as a module, without the persistent
    compilation cache its import would turn on."""
    monkeypatch.setenv("JAX_ENABLE_COMPILATION_CACHE", "0")
    monkeypatch.setattr(sys, "path", list(sys.path))  # it prepends "."
    spec = importlib.util.spec_from_file_location(
        "tpu_pipeline_probe", os.path.join(REPO, "tools", "pipeline_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_kernel_output(monkeypatch, N, M, T, h0, c0, w):
    """The Pallas kernel's [N,M,H] output in interpret mode, and the
    probe's own return value (its sum)."""
    mod = _tpu_probe(monkeypatch)
    outs = []
    real = pl.pallas_call

    def interpret(*args, **kwargs):
        call = real(*args, **dict(kwargs, interpret=True))

        def run(*operands):
            out = call(*operands)
            outs.append(out)
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", interpret)
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda fn, *a, **k: fn)
        probe = mod.make_probe(N, M, T)
    total = probe(jnp.asarray(h0), jnp.asarray(c0), jnp.asarray(w))
    assert len(outs) == 1
    return np.asarray(outs[0]), float(total)


def _inputs(N, M, c0_zero, seed=0):
    rng = np.random.default_rng(seed)
    h0 = (rng.standard_normal((N, M, H)) * 0.5).astype(np.float32)
    c0 = np.zeros((N, M, H), np.float32) if c0_zero else \
        (rng.standard_normal((N, M, H)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((N, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return h0, c0, w


@pytest.mark.parametrize("c0_zero", [True, False])
@pytest.mark.parametrize("M,T", [(4, 6), (7, 8)])
@pytest.mark.parametrize("N", [1, 2, 3])
def test_plain_matches_jax_kernel_in_interpret_mode(monkeypatch, N, M, T,
                                                    c0_zero):
    h0, c0, w = _inputs(N, M, c0_zero, seed=N * 100 + M)
    ref, total = _jax_kernel_output(monkeypatch, N, M, T, h0, c0, w)
    got = P.pipeline_probe(*(torch.from_numpy(a) for a in (h0, c0, w)), T)
    assert got.dtype == torch.float32 and got.shape == (N, M, H)
    assert ref.shape == (N, M, H)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.sum()), total, rtol=1e-5, atol=1e-3)
    # T steps really moved the state
    assert np.abs(ref - h0).max() > 1e-2


def test_plain_matches_a_float64_loop():
    h0, c0, w = _inputs(2, 5, False, seed=3)
    h, c = h0.astype(np.float64), c0.astype(np.float64)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
    for _ in range(9):
        g = np.einsum("nmk,nkj->nmj", h, w.astype(np.float64))
        s = sig(g[..., :3 * H])
        c = s[..., H:2 * H] * c + s[..., :H] * np.tanh(g[..., 3 * H:])
        h = s[..., 2 * H:] * np.tanh(c)
    got = P.pipeline_probe_plain(*(torch.from_numpy(a) for a in (h0, c0, w)), 9)
    np.testing.assert_allclose(got.numpy(), h, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", P.VARIANTS)
def test_wrapper_on_cpu_runs_the_plain_version(variant):
    h0, c0, w = (torch.from_numpy(a) for a in _inputs(2, 3, False))
    launches = {v: k.launches for v, k in P.KERNELS.items()}
    calls = P.pipeline_probe_plain.calls
    got = P.pipeline_probe(h0, c0, w, 5, variant)
    assert P.pipeline_probe_plain.calls == calls + 1
    assert {v: k.launches for v, k in P.KERNELS.items()} == launches
    assert torch.equal(got, P.pipeline_probe_plain(h0, c0, w, 5))
    # T = 0 is the initial state
    assert torch.equal(P.pipeline_probe(h0, c0, w, 0, variant), h0)


def test_wrapper_rejects_what_the_kernels_cannot_take():
    h0, c0, w = (torch.from_numpy(a) for a in _inputs(2, 3, False))
    calls = P.pipeline_probe_plain.calls
    with pytest.raises(ValueError, match="variant"):
        P.pipeline_probe(h0, c0, w, 4, "tpu")
    with pytest.raises(ValueError, match="float32"):
        P.pipeline_probe(h0.double(), c0, w, 4)
    with pytest.raises(ValueError, match="float32"):
        P.pipeline_probe(h0, c0, w.double(), 4)
    with pytest.raises(ValueError, match=r"\[N,M,320\]"):
        P.pipeline_probe(h0[..., :64].contiguous(), c0, w, 4)
    with pytest.raises(ValueError, match="shape"):
        P.pipeline_probe(h0, c0[:, :2].contiguous(), w, 4)
    with pytest.raises(ValueError, match="shape"):
        P.pipeline_probe(h0, c0, w[:1].contiguous(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        P.pipeline_probe(h0, c0.transpose(0, 1).contiguous().transpose(0, 1),
                         w, 4)
    with pytest.raises(ValueError, match="T must be"):
        P.pipeline_probe(h0, c0, w, -1)
    with pytest.raises(ValueError, match="CUDA"):
        P.pipeline_probe_l2_kernel(h0, c0, w, 4)
    with pytest.raises(ValueError, match="at most 4 chains"):
        five = (torch.from_numpy(a) for a in _inputs(5, 3, True))
        P.pipeline_probe_l2_kernel(*five, 4)
    assert P.pipeline_probe_plain.calls == calls


def test_interleaved_layout():
    w = torch.arange(2 * H * 4 * H, dtype=torch.float32).reshape(2, H, 4 * H)
    wi = P._interleave(w)
    for u, q, k in ((0, 0, 0), (5, 3, 7), (H - 1, 2, H - 1), (17, 1, 300)):
        assert wi[1, k, 4 * u + q] == w[1, k, q * H + u]


@pytest.mark.parametrize("c0_zero", [True, False])
def test_cudnn_column_mapping_matches_plain(c0_zero):
    """torch.nn.LSTM (its CPU kernel here, cuDNN on the card) with zero
    input computes the probe's chains once W's columns are reordered."""
    h0, c0, w = (torch.from_numpy(a) for a in _inputs(2, 5, c0_zero, seed=7))
    got = P.cudnn_chains(h0, c0, w, 7)()
    ref = P.pipeline_probe_plain(h0, c0, w, 7)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("r4", [1.0, 2.49, 2.5, 3.9])
def test_verdict_follows_the_tpu_probe_rule(r4):
    with open(os.path.join(REPO, "tools", "pipeline_probe.py")) as f:
        assert "if r4 < 2.5 else" in f.read()
    ms = {(96, 1): 2.0, (96, 2): 3.0, (96, 4): 2.0 * r4}
    line = P.verdict("cluster", 96, ms)
    assert line.startswith("# cluster M=96: 2 chains cost 1.50x one chain, "
                           f"4 chains {r4:.2f}x")
    assert ("latency-bound" in line) == (r4 < 2.5)
    assert ("throughput-bound" in line) == (r4 >= 2.5)


def test_grid_and_work_counts():
    assert P.grid("l2", 4, 96) == {"blocks": 48}
    assert P.grid("l2", 1, 37) == {"blocks": 19}
    assert P.grid("cluster", 4, 96) == {"clusters": 8, "blocks": 128}
    assert P.grid("cluster", 1, 100) == {"clusters": 3, "blocks": 48}
    # the operations of the TPU probe's TFLOP/s line
    assert P.flops(1, 96, 640) == 640 * 2 * 96 * 320 * 1280
    h0, c0, w = P.probe_inputs(3, 96, "cpu")
    assert h0.shape == c0.shape == (3, 96, H) and w.shape == (3, H, 4 * H)
    assert not c0.any() and h0.dtype == w.dtype == torch.float32


def test_every_ablation_cut_names_text_of_the_kernel_source():
    """--ablate builds the cluster kernel with each cut applied: every
    replaced text is in csrc/pipeline_probe.cu exactly once, and cuts the
    cluster kernel, not the l2 one."""
    from gluon_e2e_asr_tpu_torch import _build

    with open(os.path.join(_build.SRC_DIR, "pipeline_probe.cu")) as f:
        src = f.read()
    cluster = src[src.index("cluster_kernel(const float*"):]
    for name, pairs in P.CUTS.items():
        for old, new in pairs:
            assert src.count(old) == 1, name
            assert old != new
            if name != "half the rows":
                assert old in cluster, name


def test_check_inputs_keep_the_state_alive():
    """The card's comparisons after 640 steps use live_inputs: their state
    stays at |h| about 0.35 and a perturbation of the weights' last bits
    does not grow; with the TPU probe's own inputs h reaches 0."""
    h0, c0, w = P.live_inputs(2, 6, "cpu", seed=5)
    ref = P.pipeline_probe_plain(*(t.double() for t in (h0, c0, w)), 640)
    got = P.pipeline_probe_plain(h0, c0, w, 640)
    assert 0.3 < float(ref.abs().mean()) < 0.4
    assert float((got.double() - ref).abs().max()) <= 1e-5
    assert not P.pipeline_probe_plain(*P.probe_inputs(1, 4, "cpu"), 640).any()


def test_main_needs_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        P.main(["--T", "4"])
