"""K5: nearest codebook entry per row (CUDA C++, ``csrc/vq_nearest.cu``).

Replaces the Pallas kernel ``vit_tpu/kernels/vq.py:_vq_kernel`` (:36),
launched by ``_vq_impl`` (:83) behind ``nearest_code`` (:134): normalise z
and the codebook, take the argmax of z·eᵀ (or of z·e − ‖e‖²/2 without
normalisation) and write an int32 index per row, never storing the (N, C)
score matrix.

What bounds it on the H100: N·C·D fp32 FMAs (TF32 would break the Pallas
kernel's Precision.HIGHEST contract) on a few hundred KB of data, so FMA issue.
The kernel keeps each row in registers, splits the codes over 8 warps that
read each code as a shared-memory broadcast, and resolves ties toward the
lowest index in its cross-warp reduction (see the source's header).

``nearest_code`` launches the kernel for a CUDA tensor and runs
``nearest_code_ref``, the plain counterpart of ``nearest_code_xla``, for a CPU
tensor.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.kernels import _build

SUPPORTED_DIMS = (8, 12, 16, 32)

launches = 0  # kernel launches by nearest_code, for run evidence


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
        err = lib.vq_nearest(zf.data_ptr(), codebook.data_ptr(),
                             idx.data_ptr(), n, c, d, int(l2_normalize),
                             stream)
    _build.check(lib, err, "vq_nearest")
    global launches
    launches += 1
    return idx.reshape(batch_shape)
