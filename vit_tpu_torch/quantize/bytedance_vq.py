"""The Bytedance-style vector quantizer (counterpart of
``vit_tpu/quantize/bytedance_vq.py``).

fp32 throughout. The index comes from the nearest-code kernel
(``kernels/vq.py:nearest_code``, K5) with ``l2_normalize=use_l2_norm``.
Unlike the author's quantizer (``quantize/vq.py``), under ``use_l2_norm``
both the looked-up code and the input are normalised before the losses and
the straight-through estimator. The result dict holds the quantizer,
commitment and codebook losses and ``min_encoding_indices``.

``clustering_vq`` keeps the codes' usage as an EMA in the buffer
``embed_prob`` (the JAX package's ``vq_stats`` collection; not a parameter
and not in the state dict: the training entry checkpoints it apart). In a
training forward it updates that buffer and returns ``new_embedding`` in
the result dict: every code pulled toward its nearest input by a weight
that decays with its usage. The forward does not write it into the
codebook; the train step installs it before the gradient update
(``train/step.py:make_tatitok_train_step``), as the JAX step does. The
nearest input of each code is an argmin over the batch of a (N, C) fp32
distance matrix in plain torch (JAX's XLA), ties to the lowest index as
``jnp.argmin``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.quant import divide
from vit_tpu_torch.kernels.vq import nearest_code


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class BytedanceVectorQuantizer(nn.Module):
    def __init__(self, codebook_size: int = 1024, token_size: int = 256,
                 commitment_cost: float = 0.25, use_l2_norm: bool = False,
                 clustering_vq: bool = False, decay: float = 0.99,
                 device=None):
        super().__init__()
        self.codebook_size, self.token_size = codebook_size, token_size
        self.commitment_cost, self.use_l2_norm = commitment_cost, use_l2_norm
        self.clustering_vq, self.decay = clustering_vq, decay
        self.embedding = nn.Parameter(torch.empty(
            codebook_size, token_size, dtype=torch.float32, device=device))
        if clustering_vq:
            self.register_buffer("embed_prob", torch.zeros(
                codebook_size, dtype=torch.float32, device=device),
                persistent=False)

    def forward(self, z: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """z (..., token_size) → (the straight-through quantized z, fp32,
        z's shape; result)."""
        z = z.float()
        z_flat = z.reshape(-1, self.token_size)
        unnormed = z_flat
        indices = nearest_code(z_flat, self.embedding,
                               l2_normalize=self.use_l2_norm)
        quantized = F.embedding(indices.long(), self.embedding)
        if self.use_l2_norm:
            quantized, z_flat = _l2n(quantized), _l2n(z_flat)
        commitment = self.commitment_cost * torch.mean(
            (quantized.detach() - z_flat) ** 2)
        codebook = torch.mean((quantized - z_flat.detach()) ** 2)
        result = dict(quantizer_loss=commitment + codebook,
                      commitment_loss=commitment, codebook_loss=codebook,
                      min_encoding_indices=indices.reshape(z.shape[:-1]))
        if self.clustering_vq and train:
            with torch.no_grad():
                result["new_embedding"] = self._reseed(z_flat, unnormed,
                                                       indices)
        quantized = z_flat + (quantized - z_flat).detach()
        return quantized.reshape(z.shape), result

    def _reseed(self, z_flat, unnormed, indices) -> torch.Tensor:
        """Update the usage EMA in place and return the reseeded codebook
        (``vit_tpu/quantize/bytedance_vq.py:82-103``)."""
        c, decay = self.codebook_size, self.decay
        counts = torch.zeros(c, dtype=torch.float32,
                             device=indices.device).index_add_(
            0, indices.long(), torch.ones(indices.shape[0],
                                          device=indices.device))
        onehot_mean = divide(counts, indices.shape[0])
        new_prob = self.embed_prob * decay + onehot_mean * (1 - decay)
        self.embed_prob.copy_(new_prob)
        emb = self.embedding.detach()
        codes = _l2n(emb) if self.use_l2_norm else emb
        d = (torch.sum(z_flat ** 2, 1, keepdim=True)
             + torch.sum(codes ** 2, 1) - 2.0 * z_flat @ codes.T)
        random_feat = unnormed[torch.argmin(d, dim=0)]
        decay_f = torch.exp(-divide(new_prob * c * 10.0, 1 - decay)
                            - 1e-3)[:, None]
        return emb * (1 - decay_f) + random_feat * decay_f

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """Index → codebook vector, normalised under ``use_l2_norm``."""
        out = F.embedding(indices.long(), self.embedding)
        return _l2n(out) if self.use_l2_norm else out
