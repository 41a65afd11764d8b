"""Optimizer and LR schedule (counterpart of ``vit_tpu/train/optim.py:26-120``).

The JAX package chains optax transforms: a clip by global norm that records
the norm, then ``optax.adamw`` with a warmup → cosine schedule. This is the
same arithmetic written out on tensors, in the installed optax's order
(``scale_by_adam``, ``add_decayed_weights``, ``scale_by_learning_rate``):

  - the clip is ``select(‖g‖ < max_norm, g, g / ‖g‖ · max_norm)``;
  - μ ← (1 − b1)·g + b1·μ and ν ← (1 − b2)·g² + b2·ν in fp32. With a bf16
    μ (the JAX package's default ``mu_dtype``) JAX rounds the weakly typed
    b1 to bf16 (0.9 → 0.8984375) before multiplying, and XLA keeps the exact
    product in fp32; so does this code;
  - the update uses the fp32 μ before it is stored in μ's dtype, bias
    correction by 1 − b^t at the incremented count t, then
    μ̂ / (√ν̂ + eps) with eps 1e-8 outside the square root;
  - decoupled weight decay: + wd·p, on every parameter (no mask);
  - × −lr(count), the schedule evaluated at the count BEFORE the
    increment, so step 0 of a warmup has lr 0.

Everything stays on the parameters' device; nothing is read back to the
host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch


def get_lr_schedule(lr: float, warmup_steps: int, train_steps: int,
                    min_lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """SequentialLR-equivalent schedule (``vit_tpu/train/optim.py:26-44``),
    fp32, on the step tensor's device:

    step < warmup:       lr · step/warmup
    warmup ≤ step < T:   min_lr + (lr − min_lr)·(1 + cos(π·(step − warmup)/T))/2
    step ≥ T:            lr
    """

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        cos = min_lr + (lr - min_lr) * 0.5 * (
            1.0 + torch.cos(math.pi * (step - warmup_steps)
                            / max(train_steps, 1)))
        out = torch.where(step < warmup_steps, warm, cos)
        return torch.where(step >= train_steps, torch.full_like(out, lr), out)

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Clip ``grads`` in place by their global norm and return that norm
    (fp32, pre-clip): the recording clip of the JAX package."""
    g_norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm))
    return g_norm


def check_named(got: dict, want: dict, what: str) -> None:
    """Raise unless ``got`` has ``want``'s names, in order, and its
    shapes and dtypes."""
    if list(got) != list(want):
        raise KeyError(f"{what}: names differ: missing "
                       f"{sorted(set(want) - set(got))}, extra "
                       f"{sorted(set(got) - set(want))}")
    for name, t in want.items():
        if got[name].shape != t.shape or got[name].dtype != t.dtype:
            raise ValueError(f"{what} {name}: {tuple(got[name].shape)} "
                             f"{got[name].dtype}, want {tuple(t.shape)} "
                             f"{t.dtype}")


@dataclasses.dataclass
class OptState:
    """AdamW moments, the update count, and the last pre-clip gradient norm
    (None until the first update, or without a clip)."""

    count: torch.Tensor               # int32, updates taken
    mu: "list[torch.Tensor]"          # first moments, in mu_dtype
    nu: "list[torch.Tensor]"          # second moments, fp32
    grad_norm: Optional[torch.Tensor] = None

    def state_dict(self, names: Sequence[str]) -> dict:
        """The count and the moments keyed by parameter name (live
        tensors, no copies); the recorded gradient norm is not state."""
        return {"count": self.count, "mu": dict(zip(names, self.mu)),
                "nu": dict(zip(names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, sd: dict, names: Sequence[str]) -> None:
        """Copy a ``state_dict`` in place; the names, shapes and dtypes
        must be this state's."""
        for key in ("mu", "nu"):
            live = getattr(self, key)
            check_named(sd[key], dict(zip(names, live)), key)
            for t, name in zip(live, names):
                t.copy_(sd[key][name])
        self.count.copy_(sd["count"])


class Optimizer:
    """Global-norm clip (optional) → AdamW with the warmup/cosine schedule,
    applied in place to a fixed list of parameters."""

    def __init__(self, lr: float, warmup_steps: int, train_steps: int,
                 min_lr: float, weight_decay: float, *,
                 clip_norm: Optional[float] = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: Optional[str] = "bfloat16"):
        self.schedule = get_lr_schedule(lr, warmup_steps, train_steps, min_lr)
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = getattr(torch, mu_dtype) if mu_dtype else None

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        dev = params[0].device
        return OptState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in params],
            nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update_(self, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], state: OptState) -> None:
        """One step: clips ``grads`` (in place), updates ``params`` and
        ``state`` in place."""
        if self.clip_norm is not None:
            state.grad_norm = clip_by_global_norm_(grads, self.clip_norm)
        b1, b2 = self.b1, self.b2
        t = (state.count + 1).to(torch.float32)
        bc1 = 1.0 - torch.full_like(t, b1) ** t
        bc2 = 1.0 - torch.full_like(t, b2) ** t
        neg_lr = -self.schedule(state.count)
        for i, (p, g) in enumerate(zip(params, grads)):
            b1_mu = torch.tensor(b1, dtype=state.mu[i].dtype).item()
            mu = (1.0 - b1) * g + b1_mu * state.mu[i].float()
            nu = (1.0 - b2) * (g * g) + b2 * state.nu[i]
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            update = (update + self.weight_decay * p) * neg_lr
            p.add_(update.to(p.dtype))
            state.mu[i] = mu.to(state.mu[i].dtype)
            state.nu[i] = nu
        state.count += 1


def make_optimizer(lr: float, warmup_steps: int, train_steps: int,
                   min_lr: float, weight_decay: float, *,
                   clip_norm: Optional[float] = 1.0, b1: float = 0.9,
                   b2: float = 0.999,
                   mu_dtype: Optional[str] = "bfloat16") -> Optimizer:
    """The JAX package's ``make_optimizer``: AdamW (eps 1e-8, decoupled
    weight decay) with the SequentialLR schedule, after an optional global
    norm clip. ``mu_dtype`` None or "float32" keeps fp32 first moments."""
    return Optimizer(lr, warmup_steps, train_steps, min_lr, weight_decay,
                     clip_norm=clip_norm, b1=b1, b2=b2, mu_dtype=mu_dtype)
