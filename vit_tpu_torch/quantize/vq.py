"""The author's minimal L2-norm VQ (counterpart of
``vit_tpu/quantize/vq.py:38-66``).

fp32 throughout, whatever the surrounding compute dtype. The index comes from
the nearest-code kernel (``kernels/vq.py``) on the L2-normalised latent; the
quantised vector is looked up in the UN-normalised codebook, as the reference
does. In training the codebook gets its gradient only from the codebook loss,
and the encoder only through the commitment loss and the straight-through
estimator (``zn + (q − zn).detach()``), as with the JAX module's
``stop_gradient``s.
"""

from __future__ import annotations

import torch
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
        """Index → codebook vector."""
        flat = self.codebook.index_select(0, indices.reshape(-1))
        return flat.reshape(*indices.shape, self.codebook.shape[1])
