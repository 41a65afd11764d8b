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

  attention_fwd.cu         K6   attention.py:172 (_fa_kernel :76)
                           K1   attention.py:790 (_fa_packed_kernel :623),
                                K6's kernel with the bias stage (kBias);
                                on fp32 operands the same kernel over
                                three bf16 parts (kParts = 3); both at
                                head_dim 64 and 32 (kD)
  attention_bwd.cu         K7   attention.py:441 (_fa_bwd_kernel :201)
                           K8   attention.py:395 (_fa_bwd_tiled_kernel :284)
                           K2   attention.py:1072 (_fa_packed_bwd_kernel
                                :824), K7/K8's kernels with kBias
                                (both sources on hopper.cuh: TMA, mbarrier,
                                wgmma); on fp32 operands the same kernels
                                over three bf16 parts (kParts = 3)
  convnext_tail.cu         K3   convnext_block.py:248 (_fwd_kernel :89)
                           K4   convnext_block.py:276 (_bwd_kernel :109)
                                (on hopper.cuh too: a TMA ring of weight
                                tiles, wgmma); on fp32 rows the same
                                kernels over three bf16 parts (kParts = 3;
                                K4 with a z pre-pass at C 384)
  vq_nearest.cu            K5   vq.py:83 (_vq_kernel :36)
  ln_matmul.cu             K9a  ln_matmul.py:121 (_fwd_kernel :60)
                                (on hopper.cuh: a row pre-pass, then
                                wgmma fed by a TMA ring; on fp32 rows the
                                same kernel over three bf16 parts)
  ln_bwd.cu                K9b  ln_matmul.py:166 (_dgelu_kernel :148)
                           K9c  ln_matmul.py:190 (_ln_bwd_kernel :78)
  fc_grad.cu               K10  fc_grad.py:145 (_fc_grad_kernel :74)
                                (on hopper.cuh: wgmma fed by a TMA ring,
                                the splits' partials added in order by
                                each tile's last block; on fp32 operands
                                three bf16 parts)
  depthwise.cu             K11a depthwise.py:44 (_dw_kernel :24)
                           K11b depthwise.py:124 (_dw_bwd_kernel :77)
                                (on hopper.cuh: TMA halo tiles in, output
                                tiles out; a dx-only form)
  convnext_tail_q8.cu      K12a convnext_block.py:310 (_fwd_kernel_q8 :148)
                           K12b convnext_block.py:342 (_bwd_kernel_q8 :172)
                                (both on hopper.cuh: int8 wgmma, a TMA ring)
  fma_probe.cu             P    scripts/bench_vpu.py:60 (_fma_kernel :32)

The JAX package runs every Pallas kernel on operands of the compute dtype,
fp32 products at Precision.HIGHEST under ``--mixed false``. Each kernel
therefore has an fp32 form: the attention kernels, K3, K4, K9a and K10 as
fp32-accurate products of three bf16 parts on the tensor cores
(``attention_fwd.cu``, ``attention_bwd.cu``, ``convnext_tail.cu``, K9a's
``ln_matmul_fwd_f32`` and K10's ``fc_grad_f32``), the others as ``*_f32``
entries beside their bf16 ones (K9b, K9c, K12a, K12b: the kernels templated
on their row type, ``csrc/simt_f32.cuh``'s element helpers). K5 is fp32 by design and K11 takes both
dtypes through one entry.

Every entry takes pointers and the CUDA stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; :func:`check` turns a non-zero
code into an exception. :func:`compute_dtype` refuses operands outside bf16
and fp32 or of mixed dtypes, :func:`check_rows` a large row operand the
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


_zeroed: dict = {}


def zeroed(name: str, numel: int, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """At least ``numel`` elements of zero scratch for a kernel that leaves
    it zero again when it ends (K5's keys, K10's counts): one buffer for
    each (name, device, current stream), so that calls on one stream take
    it in turn and calls on two streams never share one; a larger request
    replaces it with a fresh zeroed buffer."""
    key = (name, device, torch.cuda.current_stream(device).cuda_stream)
    buf = _zeroed.get(key)
    if buf is None or buf.numel() < numel or buf.dtype != dtype:
        buf = torch.zeros(numel, dtype=dtype, device=device)
        _zeroed[key] = buf
    return buf


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
    # The attention entries end in (..., B, S, H, d, causal, threshold,
    # scale, stream): d the head width (32 or 64), then the dropout keep
    # threshold and scale, read only with a seed vector.
    drop = [u32, f32, ptr]
    # attention_packed_fwd(qkv, bias, out, m, l, seed, B, S, H, d, causal,
    #                      ...)
    lib.attention_packed_fwd.argtypes = [ptr] * 6 + [i32] * 5 + drop
    lib.attention_packed_fwd.restype = i32
    # attention_packed_bwd(qkv, bias, dout, m, l, dqkv, dbias, delta, part,
    #                      seed, B, S, H, d, causal, ...)
    lib.attention_packed_bwd.argtypes = [ptr] * 10 + [i32] * 5 + drop
    lib.attention_packed_bwd.restype = i32
    strides = ctypes.POINTER(ctypes.c_longlong)
    # attention_fwd(q, k, v, out, m, l, seed, strides, B, S, H, d, causal,
    #               ...)
    lib.attention_fwd.argtypes = [ptr] * 7 + [strides] + [i32] * 5 + drop
    lib.attention_fwd.restype = i32
    # attention_bwd(q, k, v, dout, m, l, dq, dk, dv, delta, seed, strides, B,
    #               S, H, d, causal, ...)
    lib.attention_bwd.argtypes = [ptr] * 11 + [strides] + [i32] * 5 + drop
    lib.attention_bwd.restype = i32
    # Their dynamic shared memory in bytes: attention_fwd_smem(fp32, d),
    # attention_bwd_smem(dkdv, fp32, d) (dkdv 0: the dq kernel, 1: the dk/dv
    # kernel; fp32 1: the fp32 form's; d the head width)
    lib.attention_fwd_smem.argtypes = [i32, i32]
    lib.attention_bwd_smem.argtypes = [i32, i32, i32]
    lib.attention_fwd_smem.restype = lib.attention_bwd_smem.restype = i32
    # Rows per backward block: K2's partial bias sums are (B·⌈S/rows⌉, 3D)
    lib.attention_bwd_block_rows.argtypes = []
    lib.attention_bwd_block_rows.restype = i32
    # convnext_tail_fwd(h, x, lns, lnb, w1, b1, w2, b2, gamma, y, N, C, eps,
    #                   stream)
    lib.convnext_tail_fwd.argtypes = [ptr] * 10 + [i32, i32, f32, ptr]
    lib.convnext_tail_fwd.restype = i32
    # convnext_tail_bwd(h, dy, lns, lnb, w1, b1, w2, gamma, dh, N, C, eps,
    #                   stream)
    lib.convnext_tail_bwd.argtypes = [ptr] * 9 + [i32, i32, f32, ptr]
    lib.convnext_tail_bwd.restype = i32
    # convnext_tail_smem(C, bwd, parts): K3's or K4's dynamic shared memory,
    # bytes (parts 3: K3's fp32 form)
    lib.convnext_tail_smem.argtypes = [i32, i32, i32]
    lib.convnext_tail_smem.restype = i32
    # convnext_tail_fwd_q8(h, x, lns, lnb, w1q, w1s, b1, w2q, w2s, b2, gamma,
    #                      y, N, C, eps, stream)
    lib.convnext_tail_fwd_q8.argtypes = [ptr] * 12 + [i32, i32, f32, ptr]
    lib.convnext_tail_fwd_q8.restype = i32
    # convnext_tail_fwd_q8_smem(C): K12a's dynamic shared memory, bytes
    lib.convnext_tail_fwd_q8_smem.argtypes = [i32]
    lib.convnext_tail_fwd_q8_smem.restype = i32
    # convnext_tail_bwd_q8(h, dy, lns, lnb, w1q, w1s, w2tq, w2ts, w1tq, w1ts,
    #                      b1, gamma, dh, dz, N, C, eps, stream)
    lib.convnext_tail_bwd_q8.argtypes = [ptr] * 14 + [i32, i32, f32, ptr]
    lib.convnext_tail_bwd_q8.restype = i32
    # convnext_tail_bwd_q8_smem(C): K12b's dynamic shared memory, bytes
    lib.convnext_tail_bwd_q8_smem.argtypes = [i32]
    lib.convnext_tail_bwd_q8_smem.restype = i32
    # depthwise_fwd(x, w, b, y, N, H, W, C, is_bf16, stream)
    lib.depthwise_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.depthwise_fwd.restype = i32
    # depthwise_bwd(x, g, w, dx, part, dw, db, N, H, W, C, is_bf16,
    #               part_rows, stream): x null for the dx-only form
    lib.depthwise_bwd.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    lib.depthwise_bwd.restype = i32
    # depthwise_plan(N, H, W, C, is_bf16, form, out): the tile plan of form
    # 0 (K11a), 1 (the dx-only K11b) or 2 (the full one) into out[9]
    lib.depthwise_plan.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
    lib.depthwise_plan.restype = i32
    # ln_matmul_fwd(x, w, b, z, zpre, xhat, N, C, F, gelu, stream); the fp32
    # form ln_matmul_fwd_f32(x, w, b, z, zpre, xhat, parts, N, C, F, gelu,
    # stream) with its scratch of x̂'s and W's bf16 parts
    lib.ln_matmul_fwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.ln_matmul_fwd.restype = i32
    lib.ln_matmul_fwd_f32.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    # ln_matmul_rows(x, xhat, parts, N, C, f32, stream): K9a's row pre-pass
    lib.ln_matmul_rows.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    lib.ln_matmul_rows.restype = i32
    # ln_matmul_plan(N, F, parts, out): K9a's output columns a tile, and
    # that kernel's dynamic shared memory and grid into out[0], out[1]
    lib.ln_matmul_plan.argtypes = [i32] * 3 + [ctypes.POINTER(i32)]
    lib.ln_matmul_plan.restype = i32
    # ln_matmul_dgelu(zpre, dz, dzc, n, stream)
    lib.ln_matmul_dgelu.argtypes = [ptr] * 3 + [ctypes.c_longlong, ptr]
    lib.ln_matmul_dgelu.restype = i32
    # ln_bwd(x, g, dx, N, C, stream)
    lib.ln_bwd.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
    lib.ln_bwd.restype = i32
    # fc_grad(g, x, dw, db, part, part_db, counts, N, Fo, Fi, splits,
    # stream): with splits > 1 part and part_db take the partials, and
    # counts (a zeroed int a dW tile) let each tile's last block add them
    # in order in the kernel
    lib.fc_grad.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.fc_grad.restype = i32
    # fc_grad_tiles(Fo, Fi): the bf16 form's dW tiles (its counts)
    lib.fc_grad_tiles.argtypes = [i32, i32]
    lib.fc_grad_tiles.restype = i32
    # fc_grad_smem(f32): K10's dynamic shared memory, bytes (f32 1: the fp32
    # form's)
    lib.fc_grad_smem.argtypes = [i32]
    lib.fc_grad_smem.restype = i32
    # vq_nearest(z, codebook, idx, scratch, N, C, D, l2_normalize, splits,
    #            stream)
    lib.vq_nearest.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.vq_nearest.restype = i32
    # vq_nearest_block_rows(D): K5's rows a block
    lib.vq_nearest_block_rows.argtypes = [i32]
    lib.vq_nearest_block_rows.restype = i32
    # The fp32 forms. attention_f32_fwd(parts, out, m, l, seed, strides, B,
    # S, H, d, causal, ...)
    lib.attention_f32_fwd.argtypes = [ptr] * 5 + [strides] + [i32] * 5 + drop
    # attention_f32_bwd(q, k, v, bq, bk, bv, dout, m, l, dq, dk, dv, delta,
    #                   parts, part, dbias, seed, strides, B, S, H, d, causal,
    #                   ...)
    lib.attention_f32_bwd.argtypes = [ptr] * 17 + [strides] + [i32] * 5 + drop
    # attention_f32_split(q, k, v, bq, bk, bv, dout, parts, strides, B, S, H,
    #                     d, stream): the pre-split, dout null for the
    #                     forward's
    lib.attention_f32_split.argtypes = [ptr] * 8 + [strides] + [i32] * 4 + [ptr]
    # convnext_tail_split(w1, w2, parts, C, stream): K3 fp32's pre-split
    lib.convnext_tail_split.argtypes = [ptr] * 3 + [i32, ptr]
    # convnext_tail_f32_fwd(h, x, lns, lnb, parts, b1, b2, gamma, y, N, C,
    #                       eps, stream)
    lib.convnext_tail_f32_fwd.argtypes = [ptr] * 9 + [i32, i32, f32, ptr]
    # convnext_tail_f32_bwd(h, dy, lns, lnb, parts, b1, gamma, gz, dh, N, C,
    #                       eps, stream); convnext_tail_f32_bwd_gz(C): 1 if
    # that form at width C takes the z pre-pass (gz (N, 4C) fp32 scratch)
    lib.convnext_tail_f32_bwd.argtypes = [ptr] * 9 + [i32, i32, f32, ptr]
    lib.convnext_tail_f32_bwd_gz.argtypes = [i32]
    for name, like in (("convnext_tail_fwd_q8_f32", "convnext_tail_fwd_q8"),
                       ("convnext_tail_bwd_q8_f32", "convnext_tail_bwd_q8"),
                       ("ln_matmul_dgelu_f32", "ln_matmul_dgelu"),
                       ("ln_bwd_f32", "ln_bwd")):
        getattr(lib, name).argtypes = getattr(lib, like).argtypes
    # fc_grad_f32(g, x, dw, db, part, part_db, N, Fo, Fi, splits, stream)
    lib.fc_grad_f32.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    # fma_chains_{f32,bf16}(x, out, n, iters, chains, c, d, stream)
    for name in ("fma_chains_f32", "fma_chains_bf16"):
        getattr(lib, name).argtypes = [ptr, ptr, ctypes.c_longlong, i32, i32,
                                       f32, f32, ptr]
    for name in ("attention_f32_fwd", "attention_f32_bwd",
                 "attention_f32_split", "convnext_tail_split",
                 "convnext_tail_f32_fwd", "convnext_tail_f32_bwd",
                 "convnext_tail_f32_bwd_gz", "convnext_tail_fwd_q8_f32",
                 "convnext_tail_bwd_q8_f32",
                 "ln_matmul_fwd_f32", "ln_matmul_dgelu_f32", "ln_bwd_f32",
                 "fc_grad_f32", "fma_chains_f32", "fma_chains_bf16"):
        getattr(lib, name).restype = i32
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


COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


def compute_dtype(kernel: str, *ts: torch.Tensor) -> torch.dtype:
    """The one dtype of a kernel's activation operands, bf16 or fp32 (the
    JAX package's compute dtypes); a TypeError for any other or for a mix."""
    dt = ts[0].dtype
    if dt not in COMPUTE_DTYPES or any(t.dtype != dt for t in ts):
        raise TypeError(f"{kernel} takes bf16 or fp32 operands of one dtype, "
                        f"got {', '.join(str(t.dtype) for t in ts)}")
    return dt


def check_rows(t: torch.Tensor, kernel: str, name: str) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned bf16 or fp32
    (N, ·) tensor on a CUDA device."""
    compute_dtype(kernel, t)
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{kernel} takes a contiguous, 16-byte aligned 2-D "
                         f"{name}, got {tuple(t.shape)}")
