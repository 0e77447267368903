"""The native runtime is built at first use (runtime/native.py): a missing
library is rebuilt, builds are atomic and serialized, and a failed build
makes `available()` False and `require()` raise."""

import threading

import pytest

from lzfse_rust_tpu.runtime import native

TINY = 'extern "C" int tiny_answer() { return 42; }\n'


@pytest.fixture
def tiny_runtime(tmp_path, monkeypatch):
    """Point the builder at a one-function source in a scratch build dir."""
    src = tmp_path / "tiny.cpp"
    src.write_text(TINY)
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_configure", lambda lib: None)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    return tmp_path


def test_missing_library_is_rebuilt(tiny_runtime, monkeypatch):
    assert native.available()
    so = native.library_path()
    assert so.exists() and native.require().tiny_answer() == 42
    so.unlink()
    monkeypatch.setattr(native, "_LIB", None)
    assert native.available() and so.exists()
    assert native.require().tiny_answer() == 42
    assert not list(so.parent.glob("*.tmp"))


def test_edited_source_gets_a_new_library(tiny_runtime):
    first = native.build()
    native._SRC.write_text(TINY + "// edited\n")
    second = native.build()
    assert first != second and first.exists() and second.exists()


def test_failed_build_raises(tiny_runtime):
    native._SRC.write_text("this is not C++\n")
    assert not native.available()
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        native.require()
    assert not list((tiny_runtime / "build").glob("*.tmp"))


def test_concurrent_builds_produce_one_library(tiny_runtime):
    paths, errors = [], []

    def go():
        try:
            paths.append(native.build())
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in (tiny_runtime / "build").glob("*.so")] == [
        paths[0].name]
