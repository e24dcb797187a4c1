"""The port's kernel build cache (``repro_torch._build``), on the CPU: a
library's file name must change with every file of its source's ``csrc/``
directory and with the flags, so an edited header never loads a stale build."""
import pytest

pytest.importorskip("torch")

from repro_torch import _build  # noqa: E402


@pytest.fixture
def source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "helpers.cuh"\n')
    (csrc / "helpers.cuh").write_text("// v1\n")
    monkeypatch.setitem(_build.SOURCES, "kern", csrc / "kern.cu")
    return csrc


def test_library_path_follows_an_included_header(source):
    before = _build.library_path("kern")
    (source / "helpers.cuh").write_text("// v2\n")
    assert _build.library_path("kern") != before
    (source / "helpers.cuh").write_text("// v1\n")
    assert _build.library_path("kern") == before


@pytest.mark.parametrize("change", ["source", "new_file", "flags"])
def test_library_path_changes_with_sources_and_flags(source, monkeypatch, change):
    before = _build.library_path("kern")
    if change == "source":
        (source / "kern.cu").write_text('#include "helpers.cuh"\n// edited\n')
    elif change == "new_file":
        (source / "more.cuh").write_text("// new\n")
    else:
        monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + ("-lineinfo",))
    after = _build.library_path("kern")
    assert after != before and after.parent == _build.BUILD_DIR
    assert after.name.startswith("kern-") and after.suffix == ".so"


def test_flash_attention_library_hashes_its_hopper_header():
    csrc = _build.SOURCES["flash_attention"].parent
    assert (csrc / "hopper.cuh").is_file()
    assert '#include "hopper.cuh"' in _build.SOURCES["flash_attention"].read_text()
    assert all(path.is_file() for path in _build.SOURCES.values())
