"""ctypes binding of the native C++ image pipeline (the port's own copy of
``vit_tpu/data/native.py``).

``decode_batch(jpegs, out_size, train=, seed=)`` decodes and transforms a
whole batch in C++ threads (libjpeg decode, Pillow-style triangle-filter
resize of the shorter side, random or center crop, flip, ImageNet
normalisation) into an NHWC float32 batch.

The library is built from ``native/image_pipeline.cc`` with ``g++ ... -ljpeg``
at first use into ``build/vit_tpu_torch_data/`` under the checkout, named by
a hash of the source and flags; the JAX package's ``native/libvit_tpu_data.so``
is never loaded. ``is_available()`` says whether it built (no ``g++`` or no
libjpeg headers: False), and callers take the Pillow path otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "image_pipeline.cc"
BUILD_DIR = _ROOT / "build" / "vit_tpu_torch_data"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_error = ""    # why the library did not build, when it did not


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libvit_tpu_torch_data_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                           *LIBS], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr.strip()[-2000:])
    tmp.replace(out)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            out = library_path()
            if not out.exists():
                _compile(out)
            try:
                lib = ctypes.CDLL(str(out))
            except OSError:
                # built elsewhere (a copied build/): build it here once
                _compile(out)
                lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_error = str(e)
            return None
        lib.vit_tpu_decode_batch.restype = ctypes.c_int
        lib.vit_tpu_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),          # jpegs
            ctypes.POINTER(ctypes.c_size_t),          # sizes
            ctypes.c_int,                             # n
            ctypes.c_int,                             # out_size
            ctypes.c_int,                             # train
            ctypes.c_uint64,                          # seed
            ctypes.POINTER(ctypes.c_float),           # out
            ctypes.c_int,                             # num_threads
        ]
        _lib = lib
        return _lib


def is_available() -> bool:
    """Whether the library is built (building it on the first call)."""
    return _load() is not None


def decode_batch(jpegs: List[bytes], out_size: int, *, train: bool = True,
                 seed: int = 0, num_threads: int = 8) -> np.ndarray:
    """Decode+transform a list of JPEG byte strings → (N, S, S, 3) float32
    NHWC."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native image pipeline not available: "
                           f"{build_error}")
    n = len(jpegs)
    bufs = (ctypes.c_char_p * n)(*jpegs)
    sizes = (ctypes.c_size_t * n)(*[len(j) for j in jpegs])
    out = np.empty((n, out_size, out_size, 3), np.float32)
    failures = lib.vit_tpu_decode_batch(
        bufs, sizes, n, out_size, int(train), seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if failures:
        raise IOError(f"{failures}/{n} JPEG decodes failed")
    return out
