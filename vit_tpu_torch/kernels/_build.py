"""Build ``vit_tpu_torch/csrc/*.cu`` into one shared library and load it.

The sources have a plain C interface (no PyTorch headers). Each ``.cu`` is
compiled by its own ``nvcc`` process, all started together, and one more
``nvcc`` links the objects into the library, so the build takes about as
long as the slowest source. The library lands in ``build/vit_tpu_torch/``
under the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused; the compilers' output
(``-Xptxas -v``: registers, shared memory, spills per kernel) is kept beside
it as ``<library>.log``. Nothing happens at import: the first CUDA call of a
kernel wrapper builds and loads, so a machine without ``nvcc`` imports every
module.

The sources and the Pallas kernels (``vit_tpu/kernels/``) they replace:

  attention_packed_fwd.cu  K1   attention.py:790 (_fa_packed_kernel :623)
  attention_packed_bwd.cu  K2   attention.py:1072 (_fa_packed_bwd_kernel :824)
  convnext_tail.cu         K3   convnext_block.py:248 (_fwd_kernel :89)
                           K4   convnext_block.py:276 (_bwd_kernel :109)
  vq_nearest.cu            K5   vq.py:83 (_vq_kernel :36)
  attention_fwd.cu         K6   attention.py:172 (_fa_kernel :76)
  attention_bwd.cu         K7   attention.py:441 (_fa_bwd_kernel :201)
                           K8   attention.py:395 (_fa_bwd_tiled_kernel :284)
  ln_matmul.cu             K9a  ln_matmul.py:121 (_fwd_kernel :60)
  ln_bwd.cu                K9b  ln_matmul.py:166 (_dgelu_kernel :148)
                           K9c  ln_matmul.py:190 (_ln_bwd_kernel :78)
  fc_grad.cu               K10  fc_grad.py:145 (_fc_grad_kernel :74)
  depthwise.cu             K11a depthwise.py:44 (_dw_kernel :24)
                           K11b depthwise.py:124 (_dw_bwd_kernel :77)
  convnext_tail_q8.cu      K12a convnext_block.py:310 (_fwd_kernel_q8 :148)
                           K12b convnext_block.py:342 (_bwd_kernel_q8 :172)

Every entry takes pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; :func:`check` turns a non-zero
code into an exception. :func:`check_rows` refuses a large row operand the
kernels cannot read as it is (it is never copied), and :func:`cuda_arg`
gives a small one (weights, biases, statistics) the layout they read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vit_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvit_tpu_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or "
                       "/usr/local/cuda/bin: the CUDA kernels cannot be built")


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.name}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n{text}")
        if proc.returncode:
            failed.append(f"nvcc failed with code {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{text}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_name(f"{tag}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed with code {proc.returncode}:"
                               f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        out.with_name(out.name + ".log").write_text("\n".join(log))
        os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    f32, u32 = ctypes.c_float, ctypes.c_uint
    # The attention entries end in (..., causal, threshold, scale, stream):
    # the dropout keep threshold and scale, read only with a seed vector.
    drop = [u32, f32, ptr]
    # attention_packed_fwd(qkv, bias, out, m, l, seed, B, S, H, causal, ...)
    lib.attention_packed_fwd.argtypes = [ptr] * 6 + [i32] * 4 + drop
    lib.attention_packed_fwd.restype = i32
    # attention_packed_bwd(qkv, bias, dout, m, l, dqkv, dbias, delta, part,
    #                      seed, B, S, H, causal, ...)
    lib.attention_packed_bwd.argtypes = [ptr] * 10 + [i32] * 4 + drop
    lib.attention_packed_bwd.restype = i32
    strides = ctypes.POINTER(ctypes.c_longlong)
    # attention_fwd(q, k, v, out, m, l, seed, strides, B, S, H, causal, ...)
    lib.attention_fwd.argtypes = [ptr] * 7 + [strides] + [i32] * 4 + drop
    lib.attention_fwd.restype = i32
    # attention_bwd(q, k, v, dout, m, l, dq, dk, dv, delta, seed, strides, B,
    #               S, H, causal, ...)
    lib.attention_bwd.argtypes = [ptr] * 11 + [strides] + [i32] * 4 + drop
    lib.attention_bwd.restype = i32
    # convnext_tail_fwd(h, x, lns, lnb, w1, b1, w2, b2, gamma, y, N, C, eps,
    #                   stream)
    lib.convnext_tail_fwd.argtypes = [ptr] * 10 + [i32, i32, f32, ptr]
    lib.convnext_tail_fwd.restype = i32
    # convnext_tail_bwd(h, dy, lns, lnb, w1, w1t, w2t, b1, gamma, dh, N, C,
    #                   eps, stream)
    lib.convnext_tail_bwd.argtypes = [ptr] * 10 + [i32, i32, f32, ptr]
    lib.convnext_tail_bwd.restype = i32
    # convnext_tail_fwd_q8(h, x, lns, lnb, w1q, w1s, b1, w2q, w2s, b2, gamma,
    #                      y, N, C, eps, stream)
    lib.convnext_tail_fwd_q8.argtypes = [ptr] * 12 + [i32, i32, f32, ptr]
    lib.convnext_tail_fwd_q8.restype = i32
    # convnext_tail_bwd_q8(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts,
    #                      b1, gamma, dh, N, C, eps, stream)
    lib.convnext_tail_bwd_q8.argtypes = [ptr] * 13 + [i32, i32, f32, ptr]
    lib.convnext_tail_bwd_q8.restype = i32
    # depthwise_fwd(x, w, b, y, N, H, W, C, is_bf16, stream)
    lib.depthwise_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.depthwise_fwd.restype = i32
    # depthwise_bwd_parts(N, H, W) → partial rows of depthwise_bwd's scratch
    lib.depthwise_bwd_parts.argtypes = [i32] * 3
    lib.depthwise_bwd_parts.restype = i32
    # depthwise_bwd(x, g, wf, dx, part, dw, db, N, H, W, C, is_bf16, stream)
    lib.depthwise_bwd.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.depthwise_bwd.restype = i32
    # ln_matmul_fwd(x, w, b, z, zpre, xhat, N, C, F, gelu, stream)
    lib.ln_matmul_fwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.ln_matmul_fwd.restype = i32
    # ln_matmul_dgelu(zpre, dz, dzc, n, stream)
    lib.ln_matmul_dgelu.argtypes = [ptr] * 3 + [ctypes.c_longlong, ptr]
    lib.ln_matmul_dgelu.restype = i32
    # ln_bwd(x, g, dx, N, C, stream)
    lib.ln_bwd.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
    lib.ln_bwd.restype = i32
    # fc_grad(g, x, dw, db, part, part_db, N, Fo, Fi, splits, stream)
    lib.fc_grad.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.fc_grad.restype = i32
    # vq_nearest(z, codebook, idx, N, C, D, l2_normalize, stream)
    lib.vq_nearest.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.vq_nearest.restype = i32
    lib.vit_cuda_error_string.argtypes = [i32]
    lib.vit_cuda_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built first if no build of these sources exists."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, entry: str) -> None:
    """Raise if a launch entry returned a CUDA error."""
    if err:
        msg = lib.vit_cuda_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")


def cuda_arg(t: torch.Tensor, like: torch.Tensor, name: str,
             dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous, 16-byte aligned ``dtype`` tensor on ``like``'s
    device (the kernels read 16 bytes at a time)."""
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, the kernel's operands on "
                         f"{like.device}")
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_rows(t: torch.Tensor, kernel: str, name: str) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned bf16 (N, ·)
    tensor on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{kernel} takes bf16 {name}, got {t.dtype}")
    if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{kernel} takes a contiguous, 16-byte aligned 2-D "
                         f"{name}, got {tuple(t.shape)}")
