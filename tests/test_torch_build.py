"""PyTorch port: the kernel build's library names. The digest in
``build/torch_kernels/lib<name>.<digest>.so`` covers the source, every
header it includes from ``csrc/`` and the flags, so an edited header
builds a new library instead of loading a stale one. Checked on a copy
of ``csrc/`` (no nvcc is needed to name a library)."""

import shutil

from gluon_e2e_asr_tpu_torch import _build


def test_the_port_sources_exist():
    for name in ("bilstm_fwd", "bilstm_bwd", "ctc", "las_decoder"):
        assert _build.lib_path(name).endswith(".so")


def test_an_edited_header_changes_the_library_name(tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    before = {n: _build.lib_path(n, str(src))
              for n in ("bilstm_fwd", "bilstm_bwd", "ctc")}
    with open(src / "gemm.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.lib_path(n, str(src)) for n in before}
    assert after["bilstm_bwd"] != before["bilstm_bwd"]  # includes gemm.cuh
    assert after["bilstm_fwd"] == before["bilstm_fwd"]  # does not
    assert after["ctc"] == before["ctc"]
    decoder = _build.lib_path("las_decoder", str(src))
    with open(src / "common.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.lib_path("bilstm_fwd", str(src)) != before["bilstm_fwd"]
    assert _build.lib_path("las_decoder", str(src)) != decoder


def test_the_digest_ignores_where_the_checkout_lives(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    shutil.copytree(_build.SRC_DIR, a)
    shutil.copytree(_build.SRC_DIR, b)
    for name in ("bilstm_fwd", "bilstm_bwd", "ctc", "las_decoder"):
        assert _build.lib_path(name, str(a)) == _build.lib_path(name, str(b))
