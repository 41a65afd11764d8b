"""Train state: the model's parameters, the optimizer state, the step and
an optional weight average (counterpart of ``vit_tpu/train/state.py:18-63``).

The JAX state is an immutable pytree that each step replaces; here the
parameters are the model's own tensors and ``apply_gradients`` updates them,
the moments and the step in place (no second copy of the parameters).

``--ema_decay`` d > 0 keeps ``ema_params``, a copy of the parameters that
each step, after the optimizer's update, sets to e·d + p·(1 − d) in fp32,
each product and the sum rounded as written (the JAX expression evaluated
op by op; XLA's CPU backend fuses one product into the sum).

``state_dict`` / ``load_state_dict`` carry the state to and from a
checkpoint (``train/checkpoint.py``): the step, the parameters by the
model's own names, the optimizer's count and moments (μ in its own dtype,
bf16 by default) and, only when EMA is on, ``ema_params``. Loading a state
dict without ``ema_params`` into an EMA state seeds the average from the
loaded parameters; a saved average is dropped by a state without EMA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from vit_tpu_torch.train.optim import Optimizer, OptState, check_named


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor                 # int64, on the parameters' device
    params: "list[torch.Tensor]"       # the model's trainable parameters
    opt_state: OptState
    tx: Optimizer
    names: "list[str]" = dataclasses.field(default_factory=list)
    ema_params: "Optional[list[torch.Tensor]]" = None
    ema_decay: float = 0.0

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> "TrainState":
        """One optimizer step on ``params`` (in place), then the average;
        returns ``self``."""
        self.tx.update_(self.params, grads, self.opt_state)
        if self.ema_params is not None:
            with torch.no_grad():
                d = self.ema_decay
                torch._foreach_mul_(self.ema_params, d)
                torch._foreach_add_(self.ema_params,
                                    torch._foreach_mul(self.params, 1 - d))
        self.step += 1
        return self

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer, *,
               ema_decay: float = 0.0) -> "TrainState":
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        params = [p for _, p in named]
        ema = ([p.detach().clone() for p in params] if ema_decay > 0
               else None)
        return cls(step=torch.zeros((), dtype=torch.int64,
                                    device=params[0].device),
                   params=params, opt_state=tx.init(params), tx=tx,
                   names=[n for n, _ in named], ema_params=ema,
                   ema_decay=float(ema_decay))

    def state_dict(self) -> dict:
        """The step, ``{"params": {name: tensor}}``, the optimizer state
        and, with EMA on, ``{"ema_params": {name: tensor}}``, as the live
        tensors (no copies)."""
        sd = {"step": self.step,
              "params": dict(zip(self.names, self.params)),
              "opt_state": self.opt_state.state_dict(self.names)}
        if self.ema_params is not None:
            sd["ema_params"] = dict(zip(self.names, self.ema_params))
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> "TrainState":
        """Copy a ``state_dict`` into this state in place. Raises unless the
        names, shapes and dtypes are this state's."""
        own = dict(zip(self.names, self.params))
        check_named(sd["params"], own, "params")
        for name, p in zip(self.names, self.params):
            p.copy_(sd["params"][name])
        if self.ema_params is not None:
            # a checkpoint from before EMA was on seeds it from the params
            ema = sd.get("ema_params", sd["params"])
            check_named(ema, own, "ema_params")
            for name, e in zip(self.names, self.ema_params):
                e.copy_(ema[name])
        self.step.copy_(sd["step"])
        self.opt_state.load_state_dict(sd["opt_state"], self.names)
        return self


def param_count(params: Sequence[torch.Tensor]) -> int:
    """Total parameter count (reference utils.py:3)."""
    return sum(p.numel() for p in params)


def params_str(params: Sequence[torch.Tensor]) -> str:
    return f"{param_count(params) / 1e6:.1f}M"
