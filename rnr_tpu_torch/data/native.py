"""The port's ctypes bindings of its native host runtime (port of
rnr_tpu/data/native.py): a memory-mapped OBJ parser (`rnr_obj_count`,
`rnr_obj_parse`) and a multithreaded PNG / JPEG decoder
(`rnr_image_info`, `rnr_image_decode`, `rnr_image_decode_batch`).

Host-side speed paths, not kernels.  Each library is built at first use
from the checkout's source by g++ for any x86-64 host (not
`-march=native`) into `build/rnr_tpu_torch/lib<name>-<hash>.so`, the hash
over the source and the flags:
- `obj_parse`, from the port's `rnr_tpu_torch/csrc/obj_parse.cpp` (the OBJ
  part of native/rnr_native.cpp), needs no library but libc, so it
  builds wherever g++ runs, hosts without libjpeg or libpng included;
- `rnr_native`, the decoder, from native/rnr_native.cpp with the
  Makefile's libraries (libpng, libjpeg, zlib, pthreads), where they
  are installed.
The checked-in native/librnr_native.so (built with `-march=native`
elsewhere) is never loaded.  Where a library cannot be built or loaded,
its functions here return None and their callers take their Python
paths, as rnr_tpu's do; `build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = ROOT / "build" / "rnr_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
# name: (source, libraries to link)
SOURCES = {
    "obj_parse": (Path(__file__).resolve().parents[1] / "csrc"
                  / "obj_parse.cpp", ()),
    "rnr_native": (ROOT / "native" / "rnr_native.cpp",
                   ("-lpng", "-ljpeg", "-lz", "-lpthread")),
}

# name -> the loaded library, or None once it failed in this process
_loaded: dict = {}
# name -> why the library is unavailable in this process
build_error: dict = {}


class _ObjCounts(ctypes.Structure):
    _fields_ = [("nv", ctypes.c_int64), ("nvt", ctypes.c_int64),
                ("nvn", ctypes.c_int64), ("nf", ctypes.c_int64)]


def _build(name: str) -> Path:
    """The library `name` built from its source (once per source and
    flags); raises OSError or CalledProcessError where it cannot be."""
    source, libs = SOURCES[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + libs).encode())
    h.update(source.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                        str(tmp), str(source), *libs], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
    return out


def _load(name: str):
    """The loaded library `name` (built if needed), or None where it
    cannot be built or loaded; a failure is not retried in this
    process."""
    if name in _loaded:
        return _loaded[name]
    _loaded[name] = None
    try:
        lib = ctypes.CDLL(str(_build(name)))
    except subprocess.CalledProcessError as e:
        build_error[name] = e.stderr.decode(errors="replace").strip()[-2000:]
        return None
    except (OSError, subprocess.SubprocessError) as e:
        build_error[name] = repr(e)
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    if name == "obj_parse":
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.rnr_obj_count.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(_ObjCounts)]
        lib.rnr_obj_count.restype = ctypes.c_int
        lib.rnr_obj_parse.argtypes = [ctypes.c_char_p, fp, fp, fp, ip, ip,
                                      ip]
        lib.rnr_obj_parse.restype = ctypes.c_int
    else:
        cip = ctypes.POINTER(ctypes.c_int)
        lib.rnr_image_info.argtypes = [ctypes.c_char_p, cip, cip, cip]
        lib.rnr_image_info.restype = ctypes.c_int
        lib.rnr_image_decode.argtypes = [ctypes.c_char_p, fp, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
        lib.rnr_image_decode.restype = ctypes.c_int
        lib.rnr_image_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(fp), cip, cip,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.rnr_image_decode_batch.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def get_lib():
    """The OBJ parser's library, or None where it cannot be built or
    loaded."""
    return _load("obj_parse")


def native_available() -> bool:
    """Whether load_obj(use_native=True) parses natively in this
    process."""
    return get_lib() is not None


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def parse_obj_native(path: str):
    """(v, vt, vn, f_v_idx, f_vt_idx, f_vn_idx) of an OBJ as the Python
    parser's arrays (zero-based int32 triplets, fan-triangulated; a
    corner without vt / vn gives -1), or None where the library is
    unavailable or cannot parse the file."""
    lib = get_lib()
    if lib is None:
        return None
    counts = _ObjCounts()
    if lib.rnr_obj_count(path.encode(), ctypes.byref(counts)) != 0:
        return None
    v = np.empty((counts.nv, 3), np.float32)
    vt = np.empty((max(counts.nvt, 1), 2), np.float32)
    vn = np.empty((max(counts.nvn, 1), 3), np.float32)
    fv, fvt, fvn = (np.empty((counts.nf, 3), np.int32) for _ in range(3))
    f, i = ctypes.c_float, ctypes.c_int32
    if lib.rnr_obj_parse(path.encode(), _ptr(v, f), _ptr(vt, f), _ptr(vn, f),
                         _ptr(fv, i), _ptr(fvt, i), _ptr(fvn, i)) != 0:
        return None
    return (v, vt[:counts.nvt], vn[:counts.nvn], fv, fvt, fvn)


def decode_images_native(paths: list[str], n_threads: int = 0):
    """PNG / JPEG files as float32 RGB [H, W, 3] arrays in [0, 1], decoded
    on `n_threads` threads (min(cores, 8) when 0), or None where the
    library is unavailable or an image cannot be read."""
    lib = _load("rnr_native")
    if lib is None:
        return None
    n = len(paths)
    hs, ws = (ctypes.c_int * n)(), (ctypes.c_int * n)()
    outs = []
    for k, p in enumerate(paths):
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if lib.rnr_image_info(p.encode(), ctypes.byref(h), ctypes.byref(w),
                              ctypes.byref(c)) != 0:
            return None
        hs[k], ws[k] = h.value, w.value
        outs.append(np.empty((h.value, w.value, 3), np.float32))
    fp = ctypes.POINTER(ctypes.c_float)
    path_arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out_arr = (fp * n)(*[o.ctypes.data_as(fp) for o in outs])
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    if lib.rnr_image_decode_batch(path_arr, out_arr, hs, ws, n, 3,
                                  n_threads):
        return None
    return outs
