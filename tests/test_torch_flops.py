"""The port's FLOP count (``gluon_e2e_asr_tpu_torch/utils/flops.py``)
against the JAX package's ``utils/flops.py``: every config under
``configs/`` at its own largest bucket gives the same ``fwd``, ``train``
and breakdown, float for float; the MFU's denominator is the H100's.
"""

import glob
import os
import sys

import pytest

from gluon_e2e_asr_tpu import config as jcfg
from gluon_e2e_asr_tpu.utils import flops as jflops
from gluon_e2e_asr_tpu_torch import config as tcfg
from gluon_e2e_asr_tpu_torch.data.sampler import make_bucket_specs
from gluon_e2e_asr_tpu_torch.data.tokenizer import CharTokenizer
from gluon_e2e_asr_tpu_torch.utils import flops as tflops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def largest_bucket(config):
    """(vocab, B, audio samples, labels) of the config's longest bucket."""
    dc = config.data
    specs = make_bucket_specs(dc.bucket_bounds_sec, dc.sample_rate,
                              dc.batch_size, dc.max_label_len,
                              config.frontend.hop_length, dc.dynamic_batch)
    spec = max(specs, key=lambda s: s.max_samples)
    # BPE: the learned merges plus blank, <sos>/<eos> and <unk>
    vocab = (CharTokenizer().vocab_size if dc.tokenizer == "char"
             else dc.bpe_vocab_size + 3)
    return vocab, spec.batch_size, spec.max_samples, spec.max_labels


def test_every_config_is_counted():
    assert len(CONFIGS) >= 13


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.basename(p))
def test_count_equals_the_jax_count(path):
    port, ref = tcfg.load_config(path), jcfg.load_config(path)
    shape = largest_bucket(port)
    assert shape == largest_bucket(ref)
    got = tflops.train_step_flops(port, *shape)
    want = jflops.train_step_flops(ref, *shape)
    assert got == want
    assert got["fwd"] > 0 and got["train"] == 3.0 * got["fwd"]
    assert set(got["breakdown"]) == {"frontend", "encoder", "ctc_head",
                                     "decoder"}


def test_mfu_is_taken_against_the_h100_peaks(monkeypatch):
    """989 TFLOP/s bf16 and 67 f32 (TF32 off), whatever the environment
    says: the JAX package's GLUON_PEAK_TFLOPS hook is TPU-only."""
    monkeypatch.setenv("GLUON_PEAK_TFLOPS", "1.0")
    assert tflops.peak_tflops("bfloat16") == 989.0
    assert tflops.peak_tflops("float32") == 67.0
    # the peaks chip_smoke.py's kernel bounds take
    assert chip_smoke.PEAK_BF16 == 989.0e12 and chip_smoke.PEAK_F32 == 67.0e12
    config = tcfg.Config()
    config.model.compute_dtype = "bfloat16"
    shape = (32, 96, int(12.8 * 16000), 96)
    fl = tflops.train_step_flops(config, *shape)
    m = tflops.bench_mfu(1000.0, config, *shape)
    assert m["model_tflops_per_step"] == fl["train"] / 1e12
    assert m["tflops_per_sec"] == pytest.approx(1000.0 * fl["train"] / 96 / 1e12)
    assert m["mfu"] == pytest.approx(m["tflops_per_sec"] / 989.0)
    assert m["peak_tflops"] == 989.0
