"""Build, load and launch the port's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc, by hand, into a shared library with a plain C
interface (`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`) and loaded with ctypes; no PyTorch header is included, so
a build takes seconds. Libraries go to `eioku_tpu_torch/_build/` (listed in
.gitignore) at first use and are rebuilt when their source is newer. The
compile writes to a per-process temp file that is os.rename()d into place, so
processes starting together never load a half-written library.

Every C entry point launches on the stream it is given, does not synchronise,
and returns `cudaGetLastError()`; `launch` raises on a nonzero code and counts
the launch. A failed build raises; nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

KERNELS = ("scene_diff", "nms", "flash_attention")
# nms.cu must round its IoU exactly like the reference: no contracted FMAs
_EXTRA_FLAGS = {"nms": ("-fmad=false",)}
# flash_attention.cu encodes TMA tensor maps with the driver API
# (cuTensorMapEncodeTiled): it links libcuda (the toolkit's stub at build time)
_DRIVER_LIBS = {"flash_attention"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

# launches per kernel since the last reset_launch_counts(); only `launch`
# adds to it, once per kernel launch
_launches = {name: 0 for name in KERNELS}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    lib = _lib_path(name)
    return not os.path.isfile(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def build(names=KERNELS) -> dict[str, dict]:
    """Compile every stale kernel library, one nvcc per source, all started
    together. Returns {name: {"seconds": wall, "log": nvcc output}} for the
    sources it built (ptxas' register and shared-memory report included).
    Raises KernelBuildError if any compile fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    stubs = os.path.join(os.path.dirname(os.path.dirname(nvcc)), "lib64", "stubs")
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               *_EXTRA_FLAGS.get(name, ()), "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        if name in _DRIVER_LIBS:
            cmd += [f"-L{stubs}", "-lcuda"]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.rename(tmp, _lib_path(name))  # atomic: concurrent starters race
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return out


def _configure(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    if hasattr(lib, "eioku_scene_diff"):
        lib.eioku_scene_diff.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int, vp]
        lib.eioku_scene_diff.restype = ctypes.c_int
    if hasattr(lib, "eioku_nms_keep"):
        lib.eioku_nms_keep.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_float, vp]
        lib.eioku_nms_keep.restype = ctypes.c_int
        lib.eioku_empty_launch.argtypes = [vp]
        lib.eioku_empty_launch.restype = ctypes.c_int
    if hasattr(lib, "eioku_flash_attention"):
        i32 = ctypes.c_int
        lib.eioku_flash_attention.argtypes = [
            vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, i32, vp]
        lib.eioku_flash_attention.restype = ctypes.c_int
    lib.eioku_cuda_error_string.argtypes = [ctypes.c_int]
    lib.eioku_cuda_error_string.restype = ctypes.c_char_p


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if missing or stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(_lib_path(name))
            _configure(lib)
            _libs[name] = lib
        return lib


def launch(name: str, entry: str, *args) -> None:
    """Call the C entry point `entry` of kernel library `name`, raise if the
    launch was refused, and count it."""
    lib = load(name)
    code = getattr(lib, entry)(*args)
    if code != 0:
        msg = lib.eioku_cuda_error_string(code).decode()
        raise KernelLaunchError(f"{name}: {entry} failed: CUDA error {code} ({msg})")
    _launches[name] += 1
