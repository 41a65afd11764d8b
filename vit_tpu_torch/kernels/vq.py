"""K5: nearest codebook entry per row (CUDA C++, ``csrc/vq_nearest.cu``).

Replaces the Pallas kernel ``vit_tpu/kernels/vq.py:_vq_kernel`` (:36),
launched by ``_vq_impl`` (:83) behind ``nearest_code`` (:134): normalise z
and the codebook, take the argmax of z·eᵀ (or of z·e − ‖e‖²/2 without
normalisation) and write an int32 index per row, never storing the (N, C)
score matrix.

What bounds it on the H100: N·C·D fp32 FMAs (TF32 would break the Pallas
kernel's Precision.HIGHEST contract) on a few hundred KB of data, so FMA issue.
The rows alone give too few blocks at the paths' N, so :func:`plan` also
cuts the codes into slices: a block of four warps holds 32·R rows (R a
lane) against one slice staged and normalised once in shared memory, and
the slices' bests meet in one 64-bit key a row (max score, then lowest
index; see the source's header).

``nearest_code`` launches the kernel for a CUDA tensor and runs
``nearest_code_ref``, the plain counterpart of ``nearest_code_xla``, for a CPU
tensor.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.kernels import _build

SUPPORTED_DIMS = (8, 12, 16, 32)
BLOCKS_PER_SM = 4          # the plan's aim: about four blocks an SM
MIN_SLICE = 64             # codes a slice, at least (16 a warp)
MAX_SLICE_BYTES = 40 * 1024   # a slice's codes and offsets in shared memory

launches = 0  # kernel launches by nearest_code, for run evidence


def rows_per_lane(d: int) -> int:
    """Rows a lane of K5 holds (the source's kRowsPerLane): 4, or 2 at D
    32, whose rows take 32 registers each."""
    return 4 if d <= 16 else 2


def plan(n: int, c: int, d: int, sms: int) -> dict:
    """K5's grid for N rows against C codes of D on ``sms`` SMs: row
    blocks of 32·R rows; the codes cut into ``splits`` slices of ``slice``
    codes (the last shorter, none empty) so that there are about
    BLOCKS_PER_SM blocks an SM where the rows alone give fewer, each slice
    at least MIN_SLICE codes (or all C) and its codes and offsets at most
    MAX_SLICE_BYTES."""
    rows = 32 * rows_per_lane(d)
    row_blocks = -(-n // rows)
    fewest = -(-c * (d + 1) * 4 // MAX_SLICE_BYTES)
    want = min(-(-BLOCKS_PER_SM * sms // max(row_blocks, 1)),
               max(1, c // MIN_SLICE))
    slice_ = -(-c // max(fewest, want))
    splits = -(-c // slice_)
    return dict(rows_per_lane=rows // 32, rows_per_block=rows,
                row_blocks=row_blocks, splits=splits, slice=slice_,
                blocks=row_blocks * splits)


# (N, C, D, device, stream) → (splits, scratch): a call's plan and zero
# scratch, looked up once per call (a host-bound path waits on the wrapper)
_calls: dict = {}


def _plan_call(n: int, c: int, d: int, device: torch.device):
    """The plan's slice count for (n, c, d) on ``device``, and the zero
    scratch of a sliced call on the current stream (the rows' 64-bit keys,
    then a count a row block; the kernel leaves it zero)."""
    grid = plan(n, c, d,
                torch.cuda.get_device_properties(device).multi_processor_count)
    scratch = (_build.zeroed("vq_nearest", n + grid["row_blocks"],
                             torch.int64, device)
               if grid["splits"] > 1 else None)
    return grid["splits"], scratch


def nearest_code_ref(z: torch.Tensor, codebook: torch.Tensor, *,
                     l2_normalize: bool = True) -> torch.Tensor:
    """Argmin over full pairwise squared distances (``nearest_code_xla``).
    z (N, D), codebook (C, D) → (N,) int32; ties go to the lowest index."""
    z = z.float()
    e = codebook.float()
    if l2_normalize:
        z = z / z.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        e = e / e.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    d = ((z * z).sum(-1, keepdim=True) + (e * e).sum(-1)[None]
         - 2.0 * (z @ e.T))
    return d.argmin(-1).to(torch.int32)


def nearest_code(z: torch.Tensor, codebook: torch.Tensor, *,
                 l2_normalize: bool = True) -> torch.Tensor:
    """Nearest codebook index per row. z (..., D), codebook (C, D) →
    (...,) int32. A CUDA tensor launches K5 (fp32, contiguous, D in
    ``SUPPORTED_DIMS``) or raises; a CPU tensor runs the plain version."""
    d = z.shape[-1]
    if codebook.ndim != 2 or codebook.shape[1] != d:
        raise ValueError(f"codebook must be (C, {d}), got "
                         f"{tuple(codebook.shape)}")
    if codebook.device != z.device:
        raise ValueError(f"codebook on {codebook.device}, z on {z.device}")
    batch_shape = z.shape[:-1]
    zf = z.reshape(-1, d)
    if z.device.type == "cpu":
        return nearest_code_ref(zf, codebook,
                                l2_normalize=l2_normalize).reshape(batch_shape)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"K5 takes fp32 z and codebook, got {z.dtype}, "
                        f"{codebook.dtype}")
    if d not in SUPPORTED_DIMS:
        raise NotImplementedError(f"K5 takes D in {SUPPORTED_DIMS}, got {d}")
    if not (zf.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("K5 takes contiguous z and codebook")
    n, c = zf.shape[0], codebook.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=z.device)
    lib = _build.load()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        key = (n, c, d, z.device, stream)
        call = _calls.get(key)
        if call is None:
            call = _calls[key] = _plan_call(n, c, d, z.device)
        splits, scratch = call
        err = lib.vq_nearest(zf.data_ptr(), codebook.data_ptr(),
                             idx.data_ptr(),
                             None if scratch is None else scratch.data_ptr(),
                             n, c, d, int(l2_normalize), splits, stream)
    _build.check(lib, err, "vq_nearest")
    global launches
    launches += 1
    return idx.reshape(batch_shape)
