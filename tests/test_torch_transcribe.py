"""PyTorch port: ``transcribe.py`` and ``tools/align.py`` against the JAX
package's CLIs on the blessed tiny golden, on the CPU.

Both read the golden's JAX checkpoint (the port through ``bridge.py``).
``transcribe`` (greedy and beam, ``--timestamps``; one file longer than
the config's largest bucket, so the catch-all bucket runs) and ``align
--ctm`` over the first dev utterances give the JAX CLIs' texts, token
spans and CTM exactly (the scores within 1e-4). ``.flac`` inputs (written
by the port's native encoder) give the JAX CLI's texts too; a malformed
``fLaC`` file and a missing file raise.
"""

import importlib.util
import json
import os
import wave

import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu import transcribe as jax_transcribe
from gluon_e2e_asr_tpu_torch import transcribe
from gluon_e2e_asr_tpu_torch.data.manifest import synth_waveform
from gluon_e2e_asr_tpu_torch.tools import align

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
GOLDEN = ["--config", os.path.join(GOLD, "tiny_golden.yaml"),
          "--ckpt", os.path.join(GOLD, "tiny_golden.msgpack")]
_spec = importlib.util.spec_from_file_location(
    "jax_align_tool", os.path.join(REPO, "tools", "align.py"))
jax_align = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_align)


def _write_wav(path, wave_f32, sr=16000):
    pcm = np.clip(wave_f32 * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    paths = []
    for i, text in enumerate(("abc def", "hello", "abcdefghij" * 4)):
        p = d / f"utt{i}.wav"
        _write_wav(p, synth_waveform(text, seed=i))
        paths.append(str(p))
    return paths


def _records(path):
    return [json.loads(x) for x in open(path)]


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_transcribe_matches_jax(wavs, tmp_path, capsys, method):
    assert os.path.getsize(wavs[2]) > 2 * 4.0 * 16000  # past the 4 s bucket
    args = [*GOLDEN, "--method", method, "--timestamps"]
    want = jax_transcribe.main(args + ["--output", str(tmp_path / "j.jsonl"),
                                       *wavs])
    want_lines = capsys.readouterr().out.strip().splitlines()
    got = transcribe.main(args + ["--output", str(tmp_path / "p.jsonl"),
                                  "--device", "cpu", *wavs])
    got_lines = capsys.readouterr().out.strip().splitlines()
    assert got == want and len(got) == 3
    assert got_lines[-3:] == want_lines[-3:]
    assert [ln.split("\t")[0][5:] for ln in got_lines[-3:]] == [
        "utt0.wav", "utt1.wav", "utt2.wav"]  # file order
    w = {r["utt_id"]: r for r in _records(tmp_path / "j.jsonl")}
    g = {r["utt_id"]: r for r in _records(tmp_path / "p.jsonl")}
    assert set(g) == set(w)
    for k, rg in g.items():
        assert rg["hyp"] == w[k]["hyp"]
        assert rg["tokens"] == w[k]["tokens"]
        assert len(rg["tokens"]) == len(tokens_of(rg["hyp"]))
        np.testing.assert_allclose(rg["score"], w[k]["score"], rtol=0,
                                   atol=1e-4)
    assert any(r["tokens"] for r in g.values())


def tokens_of(text):
    from gluon_e2e_asr_tpu_torch.data.tokenizer import tokenizer_from_json

    with open(os.path.join(GOLD, "tiny_golden.msgpack.json")) as f:
        return tokenizer_from_json(json.load(f)["vocab"]).encode(text)


def test_timestamps_need_an_output(wavs):
    with pytest.raises(SystemExit):
        transcribe.main([*GOLDEN, "--timestamps", "--device", "cpu", wavs[0]])


@pytest.mark.parametrize("method", ["greedy", "beam"])
def test_transcribe_flac_matches_jax(tmp_path, capsys, method):
    from gluon_e2e_asr_tpu_torch.utils.native import encode_flac

    flacs = []
    for i, text in enumerate(("abc def", "hello", "abcdefghij" * 4)):
        pcm = np.clip(np.round(synth_waveform(text, seed=10 + i) * 32767.0),
                      -32768, 32767).astype(np.int16)
        flacs.append(str(tmp_path / f"utt{i}.flac"))
        encode_flac(flacs[-1], pcm)
    args = [*GOLDEN, "--method", method]
    want = jax_transcribe.main(args + flacs)
    want_lines = capsys.readouterr().out.strip().splitlines()
    got = transcribe.main(args + ["--device", "cpu", *flacs])
    got_lines = capsys.readouterr().out.strip().splitlines()
    assert got == want and len(got) == 3
    assert got_lines[-3:] == want_lines[-3:]


def test_flac_and_missing_files_raise(tmp_path):
    flac = tmp_path / "x.flac"
    flac.write_bytes(b"fLaC")
    with pytest.raises(ValueError, match="probe_flac"):
        transcribe.main([*GOLDEN, "--device", "cpu", str(flac)])
    with pytest.raises(FileNotFoundError):
        transcribe.main([*GOLDEN, "--device", "cpu", str(tmp_path / "no.wav")])


def test_align_matches_jax(tmp_path, capsys):
    args = [*GOLDEN, "--num", "6"]
    assert jax_align.main(args + ["--output", str(tmp_path / "j.jsonl"),
                                  "--ctm", str(tmp_path / "j.ctm")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert align.main(args + ["--output", str(tmp_path / "p.jsonl"),
                              "--ctm", str(tmp_path / "p.ctm"),
                              "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("event", "num_utts", "skipped", "sec_per_frame"):
        assert got[k] == want[k], k
    assert got["num_utts"] == 6
    ctm = open(tmp_path / "p.ctm").read()
    assert ctm and ctm == open(tmp_path / "j.ctm").read()
    for rg, rw in zip(_records(tmp_path / "p.jsonl"),
                      _records(tmp_path / "j.jsonl")):
        assert {k: v for k, v in rg.items() if k not in ("score", "ts")} == \
            {k: v for k, v in rw.items() if k not in ("score", "ts")}
        np.testing.assert_allclose(rg["score"], rw["score"], rtol=0, atol=1e-4)
        assert rg["score"] > -1e20
