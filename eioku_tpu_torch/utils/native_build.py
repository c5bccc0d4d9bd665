"""Build-and-load for the repository's native C++ helpers (port copy).

Same recipe as eioku_tpu/utils/native_build.py: compile `native/{name}.cpp`
with g++ on first use and fall back cleanly (return None) when no toolchain or
linked system library exists, so callers keep their pure-Python paths. The
library goes into the port's own build directory (`eioku_tpu_torch/_build/`,
listed in .gitignore), never next to the JAX package's copy. The compile
writes to a per-process temp file and os.rename()s it into place, so worker
processes starting together never dlopen a half-written library.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

log = logging.getLogger(__name__)

_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL | None] = {}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")


def load_native_lib(name: str, configure,
                    link_libs: tuple[str, ...] = ()) -> ctypes.CDLL | None:
    """Load native/{name}.cpp as _build/lib{name}.so, building if stale.

    `configure(lib)` sets restype/argtypes; it runs once per process.
    `link_libs` adds -l<lib> flags. Returns None (and remembers the failure)
    when the toolchain, the source, or a linked system library is missing.
    """
    with _lock:
        if name in _cache:
            return _cache[name]
        src = os.path.join(NATIVE_DIR, f"{name}.cpp")
        lib_path = os.path.join(BUILD_DIR, f"lib{name}.so")
        try:
            if not os.path.isfile(lib_path) or \
                    os.path.getmtime(lib_path) < os.path.getmtime(src):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                     "-o", tmp, src] + [f"-l{lib}" for lib in link_libs],
                    check=True, capture_output=True, timeout=120)
                os.rename(tmp, lib_path)  # atomic: concurrent starters race
            lib = ctypes.CDLL(lib_path)
            configure(lib)
            _cache[name] = lib
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            log.warning("native %s unavailable (%s); using Python path",
                        name, e)
            _cache[name] = None
        return _cache[name]
