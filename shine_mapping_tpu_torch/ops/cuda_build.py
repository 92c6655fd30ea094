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


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (if the library is missing or older than
    the source) and return the library path."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= os.path.getmtime(src):
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "cached"})
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": (res.stdout + res.stderr).strip()}
    return lib_path


def build_all(names) -> None:
    """Build the given kernel sources at once, one ``nvcc`` each, all
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for f in [pool.submit(build, n) for n in names]:
            f.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name))
        return _libs[name]
