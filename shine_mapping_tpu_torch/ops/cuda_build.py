"""Build-at-first-use of the port's CUDA kernels, bound with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``csrc/build/`` (listed in
``.gitignore``), then loaded with ``ctypes``.  Nothing here runs when a
module is imported: the first kernel launch builds.  There is no fallback:
a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
# per kernel source: {"seconds": build time, "log": nvcc/ptxas output}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with nvcc "
                       "(CUDA toolkit) on the machine with the card")


def build(name: str, csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR) -> str:
    """Compile ``<csrc_dir>/<name>.cu`` (if the library is missing or older
    than the source) into ``<build_dir>`` and return the library path."""
    src = os.path.join(csrc_dir, f"{name}.cu")
    lib_path = os.path.join(build_dir, f"lib{name}.so")
    key = os.path.relpath(os.path.join(csrc_dir, name), CSRC_DIR)  # BUILD_INFO's key
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= os.path.getmtime(src):
        BUILD_INFO.setdefault(key, {"seconds": 0.0, "log": "cached"})
        return lib_path
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    BUILD_INFO[key] = {"seconds": time.perf_counter() - t0,
                       "log": (res.stdout + res.stderr).strip()}
    return lib_path


def build_all(names, csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR) -> None:
    """Build the given kernel sources at once, one ``nvcc`` each, all
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for f in [pool.submit(build, n, csrc_dir, build_dir) for n in names]:
            f.result()


def load(name: str, csrc_dir: str = CSRC_DIR, build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """The loaded library of ``<csrc_dir>/<name>.cu``, built at first use
    (``BUILD_INFO`` keys it by its path under ``csrc/`` without ``.cu``)."""
    with _lock:
        key = os.path.join(csrc_dir, name)
        if key not in _libs:
            _libs[key] = ctypes.CDLL(build(name, csrc_dir, build_dir))
        return _libs[key]
