"""The author's minimal L2-norm VQ and the FSQ variant (counterpart of
``vit_tpu/quantize/vq.py:38-104``).

fp32 throughout, whatever the surrounding compute dtype. The index comes from
the nearest-code kernel (``kernels/vq.py``) on the L2-normalised latent; the
quantised vector is looked up in the UN-normalised codebook, as the reference
does. In training the codebook gets its gradient only from the codebook loss,
and the encoder only through the commitment loss and the straight-through
estimator (``zn + (q − zn).detach()``), as with the JAX module's
``stop_gradient``s.

``FSQ`` bounds each latent channel with tanh and rounds it to ``levels[i]``
values (half to even, as ``jnp.round``), with the straight-through
estimator; it has no parameters and no loss. Its index packs the digits
with the JAX module's int32 arithmetic: computed exactly in int64, then
wrapped to int32, so prod(levels) above 2^31 (the default (8,) * 12 is
8^12) gives the same wrapped, possibly negative indices as the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.kernels.vq import nearest_code


class Quantizer(nn.Module):
    def __init__(self, codebook_size: int, latent_dim: int, beta: float = 0.25,
                 device=None):
        super().__init__()
        self.beta = beta
        self.codebook = nn.Parameter(torch.empty(
            codebook_size, latent_dim, dtype=torch.float32, device=device))

    def forward(self, z: torch.Tensor):
        """z (..., latent_dim) → (quantized_ste fp32, indices int32, loss)."""
        z32 = z.float()
        zn = z32 / z32.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        indices = nearest_code(zn, self.codebook, l2_normalize=True)
        quantized = self.lookup(indices)
        codebook_loss = torch.mean((quantized - zn.detach()) ** 2)
        commitment_loss = self.beta * torch.mean((quantized.detach() - zn) ** 2)
        quantized = zn + (quantized - zn).detach()
        return quantized, indices, codebook_loss + commitment_loss

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """Index → codebook vector. As ``F.embedding``: its backward sorts
        the indices and sums each code's rows in a fixed order, where
        ``index_select``'s adds them by atomicAdd on the card, so two runs
        from one seed would part in the codebook's gradient."""
        return F.embedding(indices.long(), self.codebook)


class FSQ(nn.Module):
    """Finite scalar quantization (``vit_tpu/quantize/vq.py:69-104``)."""

    def __init__(self, levels: Sequence[int]):
        super().__init__()
        self.levels = tuple(int(n) for n in levels)

    @property
    def codebook_size(self) -> int:
        return math.prod(self.levels)

    def forward(self, z: torch.Tensor):
        """z (..., len(levels)) → (quantized_ste fp32 in (−1, 1), indices
        int32, a zero loss)."""
        if z.shape[-1] != len(self.levels):
            raise ValueError(
                f"FSQ expects latent_dim == len(levels) ({len(self.levels)}), "
                f"got {z.shape[-1]}")
        levels = torch.tensor(self.levels, dtype=torch.float32,
                              device=z.device)
        half = (levels - 1.0) / 2.0
        bounded = torch.tanh(z.float()) * half
        rounded = torch.round(bounded)
        quantized = bounded + (rounded - bounded).detach()
        quantized = quantized / half.clamp_min(1e-12)
        # the JAX module's astype(int32): truncation toward zero
        digits = (rounded + half).detach().to(torch.int64)
        radix = torch.tensor([math.prod(self.levels[:i]) % 2 ** 32
                              for i in range(len(self.levels))],
                             dtype=torch.int64, device=z.device)
        packed = (digits * radix).sum(-1)
        indices = ((packed + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)
        return quantized, indices, torch.zeros((), device=z.device)
