"""Build-at-first-use of the port's native C++ components, bound with ctypes.

``csrc/<name>.cpp`` (plain C interface) is compiled with ``g++`` into
``csrc/build/lib<name>.so`` (listed in ``.gitignore``) the first time it is
loaded.  There is no fallback: a missing source, compiler or failed build
raises, and the caller decides whether to run its plain version instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from . import cuda_build

# where the sources are and the libraries go (module attributes, read at
# each load: a test points them elsewhere)
CSRC_DIR = cuda_build.CSRC_DIR
BUILD_DIR = cuda_build.BUILD_DIR
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``<CSRC_DIR>/<name>.cpp``, built into
    ``BUILD_DIR`` if it is missing or older than its source.  Raises
    FileNotFoundError without the source and RuntimeError when ``g++``
    fails."""
    csrc_dir, build_dir = CSRC_DIR, BUILD_DIR
    with _lock:
        key = os.path.join(csrc_dir, name)
        if key in _libs:
            return _libs[key]
        src = os.path.join(csrc_dir, f"{name}.cpp")
        if not os.path.exists(src):
            raise FileNotFoundError(f"native source {src} is missing")
        lib_path = os.path.join(build_dir, f"lib{name}.so")
        if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(src):
            os.makedirs(build_dir, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            try:
                res = subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp],
                                     capture_output=True, text=True, timeout=300)
            except FileNotFoundError as e:
                raise RuntimeError(f"g++ not found: {src} is built with g++") from e
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed on {src}:\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
        _libs[key] = ctypes.CDLL(lib_path)
        return _libs[key]
