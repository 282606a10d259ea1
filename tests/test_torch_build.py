"""The kernel build's cache key: nvcc is never run here."""
import shutil

from repro_torch.kernels import build


def test_library_path_changes_with_a_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path("flash_attention")
    assert build.library_path("flash_attention") == before   # stable
    header = csrc / "common.cuh"
    header.write_text("#pragma once\n")
    with_header = build.library_path("flash_attention")
    assert with_header != before
    header.write_text("#pragma once\n// edited\n")
    assert build.library_path("flash_attention") not in (before, with_header)
    header.unlink()
    assert build.library_path("flash_attention") == before


def test_library_path_changes_with_the_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in build.sources()}
    src = csrc / "ssd_scan.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.sources()}
    assert after["ssd_scan"] != before["ssd_scan"]
    assert {n: p for n, p in after.items() if n != "ssd_scan"} == \
        {n: p for n, p in before.items() if n != "ssd_scan"}
