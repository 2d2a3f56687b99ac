"""Builds the native host libraries from the tracked sources at first use.

native/warp.cpp becomes libmeshflow_warp (needs only g++); native/videoio.cpp
becomes libmeshflow_videoio (needs libav's headers and libraries).  Both are
built into native/build/ (not tracked), named by a hash of their sources,
the compiler flags and the host.  ``-march=native`` code, and the libav
sonames a library links, are only valid on the host that built it, so a
library copied in from another machine has another name and is never
loaded: this host builds its own.  Concurrent first uses (test workers,
threads) serialise on a file lock, and each build is renamed into place
atomically.  A library that fails to build or load counts as not available.

``scripts/build_native.sh`` runs the same builds by one command.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import socket
import subprocess
import threading

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
SOURCE_DIR = os.path.join(REPO_ROOT, "native")
BUILD_DIR = os.path.join(SOURCE_DIR, "build")

_CXXFLAGS = (
    "-O3", "-march=native", "-funroll-loops", "-fno-math-errno",
    "-fPIC", "-shared", "-std=c++17",
)
# name -> (sources under native/, link flags)
LIBRARIES = {
    "warp": (("warp.cpp",), ("-lpthread",)),
    "videoio": (
        ("videoio.cpp",),
        ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lpthread"),
    ),
}


def host_key() -> str:
    """What makes a build valid only here: architecture, CPU features
    (-march=native) and the machine itself (the libraries it links)."""
    cpu_flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    cpu_flags = line.strip()
                    break
    except OSError:
        pass
    return "|".join((platform.machine(), socket.gethostname(), cpu_flags))


def library_path(name: str, build_dir: str = BUILD_DIR) -> str:
    """Where this host's build of library `name` lives."""
    sources, link = LIBRARIES[name]
    digest = hashlib.sha256()
    for src in sources:
        with open(os.path.join(SOURCE_DIR, src), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(_CXXFLAGS + link).encode())
    digest.update(host_key().encode())
    return os.path.join(
        build_dir, f"libmeshflow_{name}-{digest.hexdigest()[:16]}.so"
    )


def build(name: str, build_dir: str = BUILD_DIR) -> str:
    """Build library `name` for this host unless it exists; returns its
    path.  Raises subprocess.CalledProcessError when the compiler fails."""
    path = library_path(name, build_dir)
    if os.path.exists(path):
        return path
    os.makedirs(build_dir, exist_ok=True)
    sources, link = LIBRARIES[name]
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):  # another process built it meanwhile
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [
            "g++", *_CXXFLAGS,
            *(os.path.join(SOURCE_DIR, s) for s in sources),
            "-o", tmp, *link,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


_loaded: dict = {}
_errors: dict = {}
_load_lock = threading.Lock()


def load(name: str) -> ctypes.CDLL | None:
    """This host's library `name` (built at first use), or None when it
    cannot be built or loaded here; error(name) then says why."""
    with _load_lock:
        if name not in _loaded:
            try:
                _loaded[name] = ctypes.CDLL(build(name))
            except subprocess.CalledProcessError as e:
                _loaded[name] = None
                lines = [ln for ln in (e.stderr or "").splitlines() if "error" in ln]
                _errors[name] = lines[0].strip() if lines else str(e)
            except OSError as e:  # no compiler, or the library will not load
                _loaded[name] = None
                _errors[name] = str(e)
        return _loaded[name]


def error(name: str) -> str | None:
    """Why library `name` is not available (None if it is, or untried)."""
    return _errors.get(name)
