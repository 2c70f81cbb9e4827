"""The native library's build key: sources, flags and host target."""
import ctypes
import os

from siga_tpu import native

FLAGS = ("-O1", "-shared", "-fPIC")


def _source(tmp_path, value):
    src = tmp_path / "probe.cpp"
    src.write_text(f'extern "C" int probe() {{ return {value}; }}\n')
    return [str(src)]


def test_changed_source_or_flags_rebuilds(tmp_path):
    out = str(tmp_path / "build")
    src = _source(tmp_path, 1)
    p1 = native.build_library(src, FLAGS, out, name="probe")
    assert native.build_library(src, FLAGS, out, name="probe") == p1
    assert ctypes.CDLL(p1).probe() == 1

    src = _source(tmp_path, 2)
    p2 = native.build_library(src, FLAGS, out, name="probe")
    assert p2 != p1
    assert ctypes.CDLL(p2).probe() == 2

    p3 = native.build_library(src, ("-O2",) + FLAGS[1:], out, name="probe")
    assert p3 not in (p1, p2)
    assert sorted(os.listdir(out)) == sorted(
        [".lock"] + [os.path.basename(p) for p in (p1, p2, p3)]
    )


def test_library_of_another_host_is_not_loaded(tmp_path, monkeypatch):
    out = str(tmp_path / "build")
    src = _source(tmp_path, 3)
    here = native.build_library(src, FLAGS, out, name="probe")
    # the same sources and flags, keyed for another CPU, name another file:
    # the library built here is not picked up there, and vice versa
    monkeypatch.setattr(native, "host_target", lambda flags=FLAGS: "other-cpu")
    there = native.build_library(src, FLAGS, out, name="probe")
    assert there != here
    assert os.path.exists(there) and os.path.exists(here)


def test_repo_library_carries_its_key():
    path = native.build_library()
    key = native.build_key(native._SRC, native.FLAGS, native.host_target())
    assert os.path.basename(path) == f"libsiga_native-{key}.so"
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.available()


def test_failed_build_is_reported(tmp_path, capsys, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", [str(bad)])
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.get_lib() is None
    assert "native library unavailable" in capsys.readouterr().err
