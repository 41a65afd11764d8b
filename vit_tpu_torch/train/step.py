"""Train and eval step factories (counterpart of
``vit_tpu/train/step.py:22-214`` and ``train_videogpt.py:127-149``).

One call runs forward, loss, backward, clip, AdamW and the metrics. Metrics
stay device tensors (nothing is read back to the host inside the step); the
caller decides when to synchronise. Where the JAX step folds its dropout key
with the step count, the port's steps take an explicit ``torch.Generator``
on the model's device, which advances with every draw. The MAE and Puzzle
steps draw their mask noise from it too, or take the noise as an argument
(the JAX draw cannot be reproduced in torch; the parity tests pass it).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.train.state import TrainState
from vit_tpu_torch.utils.metrics import tree_histograms


def make_classifier_train_step(model: nn.Module) -> Callable:
    """ViT classification step (``vit_tpu/train/step.py:22-44``, reference
    train_vit.py:96-110): mean softmax cross-entropy of the fp32 logits on
    integer labels, its gradients and the optimizer step, with the model in
    training mode (dropout from ``generator``).

    ``train_step(state, images, labels, generator=None) → (state, metrics)``
    with ``metrics`` holding ``train/loss``, ``train/acc`` and, when the
    optimizer clips, ``train/grad_norm``."""

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor,
                   generator: "torch.Generator | None" = None):
        model.train()
        logits = model(images, generator)
        loss = F.cross_entropy(logits, labels.long())
        grads = torch.autograd.grad(loss, state.params)
        state.apply_gradients(grads)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        metrics = {"train/loss": loss.detach(), "train/acc": acc}
        if state.opt_state.grad_norm is not None:   # recorded by the clip
            metrics["train/grad_norm"] = state.opt_state.grad_norm
        return state, metrics

    return train_step


def make_classifier_eval_step(model: nn.Module) -> Callable:
    """Validation step (``vit_tpu/train/step.py:204-214``, reference
    train_vit.py:114-125): CE and accuracy in eval mode, without a graph;
    deterministic, so ``generator`` is never drawn from. The model's mode
    is restored afterwards.

    ``eval_step(images, labels, generator=None) → metrics`` with
    ``valid/loss`` and ``valid/acc``."""

    def eval_step(images: torch.Tensor, labels: torch.Tensor,
                  generator: "torch.Generator | None" = None):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                logits = model(images, generator)
        finally:
            model.train(was_training)
        return {"valid/loss": F.cross_entropy(logits, labels.long()),
                "valid/acc": (logits.argmax(-1) == labels).float().mean()}

    return eval_step


def mark_usage_(usage: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``usage[indices] = 1`` in place with the JAX scatter's rules
    (``usage.at[indices].set(1.0)``): an index in [−n, −1] counts from the
    end and one outside [−n, n) is dropped. FSQ's wrapped int32 indices
    (``quantize/vq.py``) can be either. No host sync: a dropped index adds
    a 0 to code 0 under ``amax`` instead."""
    n = usage.shape[0]
    idx = indices.reshape(-1).long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    return usage.scatter_reduce_(0, torch.where(valid, idx, 0),
                                 valid.to(usage.dtype), reduce="amax")


def make_tokenizer_train_step(model: nn.Module, *,
                              perceptual_loss_fn: Optional[Callable] = None,
                              perceptual_weight: float = 1.0,
                              pixel_loss: str = "l2",
                              watch: bool = False) -> Callable:
    """Tokenizer (TiTok) step: pixel MSE (``pixel_loss="l1"``: mean absolute
    error) + perceptual_weight · perceptual loss + the quantizer's loss.

    ``train_step(state, images, usage) → (state, usage, metrics, recon)``
    with ``state.params`` the parameters of ``model``. ``usage`` is the
    (codebook_size,) fp32 bitmap of codes seen, set in place by
    ``mark_usage_``. ``watch=True`` (``--watch``) adds ``metrics["_hists"]``:
    each gradient's and each parameter's (before the update) 64-bin
    histogram, ``{"grad_hist/<JAX leaf path>": (counts, edges), ...,
    "param_hist/...": ...}`` on the device. The JAX step also takes a
    dropout key; dropout is 0 in every TiTok config and is not ported."""
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
        metrics = {"train/loss": loss, "train/recon_loss": recon_loss,
                   "train/quant_loss": quantize_loss,
                   "train/perceptual_loss": perc, "train/l1_loss": pix}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if watch:
            metrics["_hists"] = {
                **tree_histograms(dict(zip(state.names, grads)), "grad_hist"),
                **tree_histograms(dict(zip(state.names, state.params)),
                                  "param_hist")}
        state.apply_gradients(grads)
        mark_usage_(usage, indices)
        if state.opt_state.grad_norm is not None:   # recorded by the clip
            metrics["train/grad_norm"] = state.opt_state.grad_norm
        metrics["train/codebook_usage"] = usage.mean()
        return state, usage, metrics, recon.detach()

    return train_step


def make_tatitok_train_step(model: nn.Module, *,
                            perceptual_loss_fn: Optional[Callable] = None,
                            perceptual_weight: float = 1.1,
                            watch: bool = False) -> Callable:
    """TATiTok step (``train_tatitok.py:195-239``): the pixel MSE (which the
    JAX entry logs as ``train/l1_loss``) + perceptual_weight · the
    perceptual loss + the quantizer's loss, its gradients and the
    optimizer step, the model's quantizer in its training form. Under
    ``clustering_vq`` the forward updates the usage EMA and the reseeded
    codebook (``new_embedding``) replaces the codebook before the gradient
    update, on every call (every micro-step under ``MultiSteps``).

    ``train_step(state, images, usage) → (state, usage, metrics, recon)``
    as ``make_tokenizer_train_step``'s, with the JAX entry's metric names;
    ``watch=True`` adds the histograms (of the parameters before the
    codebook is replaced)."""

    def train_step(state: TrainState, images: torch.Tensor,
                   usage: torch.Tensor):
        recon, result = model(images, None, True)
        recon32, images32 = recon.float(), images.float()
        l1_loss = torch.mean((recon32 - images32) ** 2)
        if perceptual_loss_fn is not None:
            perc = perceptual_weight * perceptual_loss_fn(recon32, images32)
        else:
            perc = torch.zeros((), device=images.device)
        recon_loss = l1_loss + perc
        loss = recon_loss + result["quantizer_loss"]
        grads = torch.autograd.grad(loss, state.params)
        metrics = {"train/loss": loss, "train/recon_loss": recon_loss,
                   "train/quant_loss": result["quantizer_loss"],
                   "train/perceptual_loss": perc, "train/l1_loss": l1_loss}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if watch:
            metrics["_hists"] = {
                **tree_histograms(dict(zip(state.names, grads)), "grad_hist"),
                **tree_histograms(dict(zip(state.names, state.params)),
                                  "param_hist")}
        if "new_embedding" in result:
            with torch.no_grad():
                model.quantize.embedding.copy_(result["new_embedding"])
        state.apply_gradients(grads)
        mark_usage_(usage, result["min_encoding_indices"])
        metrics["train/codebook_usage"] = usage.mean()
        return state, usage, metrics, recon.detach()

    return train_step


def make_videogpt_train_step(model: nn.Module) -> Callable:
    """VideoGPT step: the frozen tokenizer codes each frame under
    ``no_grad``, then the AR prior's next-token CE, its gradients and the
    optimizer step (reference loop train_videogpt.py:118-136).

    ``train_step(state, tokenizer, videos, generator=None) → (state,
    tokens, metrics)`` with ``state.params`` the parameters of ``model``,
    ``tokenizer`` a ``models.pretrained.FrozenTokenizer`` (where the JAX step
    takes the tokenizer's params: the port's module carries its own, so the
    JAX factory's tokenizer argument has nothing left to do here), ``videos``
    (B, T, H, W, 3) in [0, 1] and ``generator`` the source of the prior's
    dropout (``--dropout``) while it trains. ``tokens`` are the (B, T, K)
    int32 codes; ``metrics`` holds ``train/loss`` as a device tensor."""

    def train_step(state: TrainState, tokenizer, videos: torch.Tensor,
                   generator: "torch.Generator | None" = None):
        b, t = videos.shape[:2]
        with torch.no_grad():
            frames = videos.reshape(b * t, *videos.shape[2:])
            tokens = tokenizer.encode_indices(frames).reshape(b, t, -1)
        _, loss = model(tokens, generator)
        grads = torch.autograd.grad(loss, state.params)
        state.apply_gradients(grads)
        return state, tokens, {"train/loss": loss.detach()}

    return train_step


def _pretrain_metrics(state: TrainState, loss: torch.Tensor, **more) -> dict:
    metrics = {"train/loss": loss.detach(),
               **{k: v.detach() for k, v in more.items()}}
    if state.opt_state.grad_norm is not None:   # recorded by the clip
        metrics["train/grad_norm"] = state.opt_state.grad_norm
    return metrics


def _eval(model: nn.Module, images: torch.Tensor, noise, generator):
    """The model's output in eval mode without a graph, its mode restored."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(images, noise, generator)
    finally:
        model.train(was_training)


def make_mae_train_step(model: nn.Module) -> Callable:
    """MAE pretraining step (``vit_tpu/train/step.py:119-145``): the
    masked-patch MSE of ``models/mae.py:mae_loss``, its gradients and the
    optimizer step, in training mode. The JAX entries build the optimizer
    without a clip, so there is no ``train/grad_norm`` unless one clips.

    ``train_step(state, images, generator=None, noise=None) → (state,
    metrics)``: the mask noise (B, n_patches) is ``noise`` or drawn from
    ``generator``, whose state the caller sets per step (the JAX step folds
    its key with the step, so masks differ per step and replay on
    resume)."""
    from vit_tpu_torch.models.mae import mae_loss

    cfg = model.config

    def train_step(state: TrainState, images: torch.Tensor,
                   generator: "torch.Generator | None" = None,
                   noise: "torch.Tensor | None" = None):
        model.train()
        pred, mask = model(images, noise, generator)
        loss = mae_loss(pred, images, mask, cfg.patch_size, cfg.norm_pix)
        grads = torch.autograd.grad(loss, state.params)
        state.apply_gradients(grads)
        return state, _pretrain_metrics(state, loss)

    return train_step


def make_mae_eval_step(model: nn.Module) -> Callable:
    """Validation (``vit_tpu/train/step.py:148-162``): the same masked loss
    in eval mode. ``eval_step(images, generator=None, noise=None) →
    {"valid/loss"}``; the JAX entry reuses one mask key for every batch, so
    the caller gives ``generator`` the same state before each."""
    from vit_tpu_torch.models.mae import mae_loss

    cfg = model.config

    def eval_step(images: torch.Tensor,
                  generator: "torch.Generator | None" = None,
                  noise: "torch.Tensor | None" = None):
        pred, mask = _eval(model, images, noise, generator)
        return {"valid/loss": mae_loss(pred, images, mask, cfg.patch_size,
                                       cfg.norm_pix)}

    return eval_step


def make_puzzle_train_step(model: nn.Module) -> Callable:
    """Puzzle pretraining step (``vit_tpu/train/step.py:165-188``): the
    masked position cross-entropy of ``models/puzzle.py:puzzle_loss``, its
    gradients and the optimizer step; ``train/pos_acc`` beside
    ``train/loss``. Called as the MAE step."""
    from vit_tpu_torch.models.puzzle import puzzle_loss

    def train_step(state: TrainState, images: torch.Tensor,
                   generator: "torch.Generator | None" = None,
                   noise: "torch.Tensor | None" = None):
        model.train()
        logits, mask = model(images, noise, generator)
        loss, acc = puzzle_loss(logits, mask)
        grads = torch.autograd.grad(loss, state.params)
        state.apply_gradients(grads)
        return state, _pretrain_metrics(state, loss, **{"train/pos_acc": acc})

    return train_step


def make_puzzle_eval_step(model: nn.Module) -> Callable:
    """Validation (``vit_tpu/train/step.py:191-200``): ``valid/loss`` and
    ``valid/pos_acc`` in eval mode, called as the MAE eval step."""
    from vit_tpu_torch.models.puzzle import puzzle_loss

    def eval_step(images: torch.Tensor,
                  generator: "torch.Generator | None" = None,
                  noise: "torch.Tensor | None" = None):
        loss, acc = puzzle_loss(*_eval(model, images, noise, generator))
        return {"valid/loss": loss, "valid/pos_acc": acc}

    return eval_step
