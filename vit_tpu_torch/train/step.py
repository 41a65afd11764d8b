"""Train step factories (counterpart of ``vit_tpu/train/step.py:47-116`` and
``train_videogpt.py:127-149``).

One call runs forward, loss, backward, clip, AdamW and the metrics. Metrics
stay device tensors (nothing is read back to the host inside the step); the
caller decides when to synchronise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from vit_tpu_torch.train.state import TrainState


def make_tokenizer_train_step(model: nn.Module, *,
                              perceptual_loss_fn: Optional[Callable] = None,
                              perceptual_weight: float = 1.0,
                              pixel_loss: str = "l2") -> Callable:
    """Tokenizer (TiTok) step: pixel MSE (``pixel_loss="l1"``: mean absolute
    error) + perceptual_weight · perceptual loss + the quantizer's loss.

    ``train_step(state, images, usage) → (state, usage, metrics, recon)``
    with ``state.params`` the parameters of ``model``. ``usage`` is the
    (codebook_size,) fp32 bitmap of codes seen, set in place:
    ``usage[indices] = 1``. The JAX step also takes a dropout key; dropout is
    0 in every TiTok config and is not ported."""
    if pixel_loss not in ("l1", "l2"):
        raise ValueError(f"unknown pixel_loss {pixel_loss!r}")

    def train_step(state: TrainState, images: torch.Tensor,
                   usage: torch.Tensor):
        recon, indices, quantize_loss = model(images)
        recon32, images32 = recon.float(), images.float()
        if pixel_loss == "l1":
            pix = torch.mean(torch.abs(recon32 - images32))
        else:
            pix = torch.mean((recon32 - images32) ** 2)
        if perceptual_loss_fn is not None:
            perc = perceptual_weight * perceptual_loss_fn(recon32, images32)
        else:
            perc = torch.zeros((), device=images.device)
        recon_loss = pix + perc
        loss = recon_loss + quantize_loss
        grads = torch.autograd.grad(loss, state.params)
        state.apply_gradients(grads)
        usage.index_fill_(0, indices.reshape(-1).long(), 1.0)
        metrics = {"train/loss": loss, "train/recon_loss": recon_loss,
                   "train/quant_loss": quantize_loss,
                   "train/perceptual_loss": perc, "train/l1_loss": pix}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if state.opt_state.grad_norm is not None:   # recorded by the clip
            metrics["train/grad_norm"] = state.opt_state.grad_norm
        metrics["train/codebook_usage"] = usage.mean()
        return state, usage, metrics, recon.detach()

    return train_step


def make_videogpt_train_step(model: nn.Module) -> Callable:
    """VideoGPT step: the frozen tokenizer codes each frame under
    ``no_grad``, then the AR prior's next-token CE, its gradients and the
    optimizer step (reference loop train_videogpt.py:118-136).

    ``train_step(state, tokenizer, videos) → (state, tokens, metrics)``
    with ``state.params`` the parameters of ``model``, ``tokenizer`` a
    ``models.pretrained.FrozenTokenizer`` (where the JAX step takes the
    tokenizer's params: the port's module carries its own, so the JAX
    factory's tokenizer argument has nothing left to do here) and ``videos``
    (B, T, H, W, 3) in [0, 1]. ``tokens`` are the (B, T, K) int32 codes;
    ``metrics`` holds ``train/loss`` as a device tensor."""

    def train_step(state: TrainState, tokenizer, videos: torch.Tensor):
        b, t = videos.shape[:2]
        with torch.no_grad():
            frames = videos.reshape(b * t, *videos.shape[2:])
            tokens = tokenizer.encode_indices(frames).reshape(b, t, -1)
        _, loss = model(tokens)
        grads = torch.autograd.grad(loss, state.params)
        state.apply_gradients(grads)
        return state, tokens, {"train/loss": loss.detach()}

    return train_step
