"""Native libraries build from the tracked sources, per host."""

import ctypes
import os

from meshflow.utils import native_build


def test_native_build_from_source_and_host_key(tmp_path, monkeypatch):
    build_dir = str(tmp_path / "build")
    path = native_build.build("warp", build_dir)
    assert os.path.dirname(path) == build_dir and os.path.exists(path)
    assert hasattr(ctypes.CDLL(path), "mf_render_cropped")
    assert native_build.build("warp", build_dir) == path  # no rebuild

    # A library built on another host (or copied from one) carries that
    # host's key in its name; this host never loads it and builds its own.
    monkeypatch.setattr(native_build, "host_key", lambda: "another-host|x86_64|")
    foreign = native_build.build("warp", build_dir)
    monkeypatch.undo()
    assert foreign != path and os.path.exists(foreign)
    os.unlink(path)
    assert native_build.library_path("warp", build_dir) == path
    assert native_build.build("warp", build_dir) == path
    assert os.path.exists(path)
