"""Build the CUDA sources in `rnr_tpu_torch/csrc/` and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/rnr_tpu_torch/lib<name>-<hash>.so`
at first use (the hash covers the source, the shared headers and the
flags, so an edited source is rebuilt).  The sources have a plain C
interface: no PyTorch headers, so nvcc takes seconds, not minutes.
Every entry point takes device pointers and the stream as `c_void_p`
and returns `cudaGetLastError()` as an int.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rnr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source: the rasterizer's inside tests and depths pick a
# discrete winner, so its products and sums round one by one, as in its
# plain version (no FMA contraction)
SOURCE_FLAGS = {"rasterize_tiles": ("-fmad=false",)}

_libs: dict[str, ctypes.CDLL] = {}
# per-library record of the last build: seconds and nvcc's -Xptxas -v
# report (registers, shared memory, spills of every kernel)
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of rnr_tpu_torch "
                       "are built on the machine with the GPU")


def _flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(_flags(src.stem)).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; cached per process."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}-{_digest(src)}.so"
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (rc {res.returncode}):\n"
                f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
        build_info[name] = {"seconds": secs, "ptxas": res.stderr}
    else:
        build_info.setdefault(name, {"seconds": 0.0, "ptxas": "(cached)"})
    lib = ctypes.CDLL(str(out))
    _libs[name] = lib
    return lib


def load_all(names) -> None:
    """Build and load several sources at once: one nvcc per source, all
    started together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        list(pool.map(load, names))


_fns: dict[tuple, ctypes._CFuncPtr] = {}


def fn(name: str, symbol: str, n_ptr: int, n_int: int, n_float: int = 0):
    """A C entry point `int symbol(ptr * n_ptr, int * n_int, float *
    n_float, stream)` with its ctypes signature set; cached per process,
    so a launch pays no lookup."""
    key = (name, symbol, n_ptr, n_int, n_float)
    f = _fns.get(key)
    if f is None:
        f = getattr(load(name), symbol)
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _fns[key] = f
    return f
