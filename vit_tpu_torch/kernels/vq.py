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

D 8, 12, 16 and 32 (``TUNED_DIMS``) hold the rows in registers; every
other D runs the source's runtime-D form, a register tile of 64 rows × 128
codes a block with D staged in chunks of 16, the same tie rule and merge
(with normalisation it scores z·e times the code's scale: a row's scale
does not move its argmax). Its shared memory does not grow with D, so it
takes every width, as the JAX package's ``nearest_code`` does.

``nearest_code`` launches the kernel for a CUDA tensor and runs
``nearest_code_ref``, the plain counterpart of ``nearest_code_xla``, for a CPU
tensor.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.kernels import _build

TUNED_DIMS = (8, 12, 16, 32)   # the rows in registers
BLOCKS_PER_SM = 4          # the plan's aim: about four blocks an SM
MIN_SLICE = 64             # codes a slice, at least (16 a warp), where they fit
MAX_SLICE_BYTES = 40 * 1024   # a tuned slice's codes and offsets in shared memory
ANY_ROWS = 64              # the runtime-D form's rows a block
ANY_CODES = 128            # and codes a tile
ANY_ROWS_PER_THREAD = 8    # and a thread's rows (× 8 codes)

launches = 0  # kernel launches by nearest_code, for run evidence


def rows_per_lane(d: int) -> int:
    """Rows a thread of K5 holds: in the tuned forms (the source's
    kRowsPerLane) 4, or 2 at D 32, whose rows take 32 registers each; in
    the runtime-D form ``ANY_ROWS_PER_THREAD`` (against 8 codes)."""
    if d in TUNED_DIMS:
        return 4 if d <= 16 else 2
    return ANY_ROWS_PER_THREAD


def rows_per_block(d: int) -> int:
    """Rows a K5 block holds (the source's ``vq_nearest_block_rows``)."""
    return 32 * rows_per_lane(d) if d in TUNED_DIMS else ANY_ROWS


def smem_bytes(d: int, slice_: int) -> int:
    """Dynamic shared memory of a K5 block: the tuned form's slice of codes
    and offsets; none in the runtime-D form, whose tiles are static."""
    return slice_ * (d + 1) * 4 if d in TUNED_DIMS else 0


def plan(n: int, c: int, d: int, sms: int) -> dict:
    """K5's grid for N rows against C codes of D on ``sms`` SMs: row
    blocks of ``rows_per_block(d)`` rows; the codes cut into ``splits``
    slices of ``slice`` codes (the last shorter, none empty) so that there
    are about BLOCKS_PER_SM blocks an SM where the rows alone give fewer.
    In the tuned form each slice has at least MIN_SLICE codes (or all C)
    where that many fit, and its codes and offsets at most MAX_SLICE_BYTES;
    in the runtime-D form a slice is whole tiles of ANY_CODES codes, as the
    source cuts them from ``splits``."""
    rows = rows_per_block(d)
    row_blocks = -(-n // rows)
    want = -(-BLOCKS_PER_SM * sms // max(row_blocks, 1))
    if d in TUNED_DIMS:
        fit = MAX_SLICE_BYTES // ((d + 1) * 4)    # codes a slice can hold
        fewest = -(-c // fit)
        want = min(want, max(1, c // min(MIN_SLICE, fit)))
        slice_ = -(-c // max(fewest, want))
        splits = -(-c // slice_)
    else:
        tiles = -(-c // ANY_CODES)
        splits = -(-tiles // -(-tiles // min(want, tiles)))
        slice_ = -(-tiles // splits) * ANY_CODES
    return dict(rows_per_lane=rows_per_lane(d), rows_per_block=rows,
                row_blocks=row_blocks, splits=splits, slice=slice_,
                blocks=row_blocks * splits,
                smem_bytes=smem_bytes(d, slice_))


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
    (...,) int32. A CUDA tensor launches K5 (fp32, contiguous) or raises;
    a CPU tensor runs the plain version. D < 1 raises on either."""
    d = z.shape[-1]
    if codebook.ndim != 2 or codebook.shape[1] != d:
        raise ValueError(f"codebook must be (C, {d}), got "
                         f"{tuple(codebook.shape)}")
    if codebook.device != z.device:
        raise ValueError(f"codebook on {codebook.device}, z on {z.device}")
    if d < 1:
        raise ValueError(f"K5 takes D ≥ 1, got {d}")
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
