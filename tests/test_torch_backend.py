"""The port's kernel build: the name of a built library changes with its
source, with any shared header under ``csrc/`` and with nothing else, so
an edited source or header is never served from a stale library.  No
``nvcc`` runs here: only the target names are computed."""
import pytest

from repro_torch.kernels import backend


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "common.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(backend, "CSRC", tmp_path)
    return tmp_path


def test_editing_a_header_renames_every_target(csrc):
    before = {n: backend._target(n) for n in ("a", "b")}
    assert backend._target("a") == before["a"]         # deterministic
    (csrc / "common.cuh").write_text("#pragma once\nint x;\n")
    after = {n: backend._target(n) for n in ("a", "b")}
    assert all(after[n] != before[n] for n in before)
    (csrc / "other.cuh").write_text("")                # a new header too
    assert backend._target("a") != after["a"]


def test_editing_a_source_renames_only_its_target(csrc):
    before = {n: backend._target(n) for n in ("a", "b")}
    (csrc / "b.cu").write_text("int b = 1;\n")
    assert backend._target("a") == before["a"]
    assert backend._target("b") != before["b"]
    assert backend._target("b").name.startswith("libb-")
