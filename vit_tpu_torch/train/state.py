"""Train state: the model's parameters, the optimizer state and the step
(counterpart of ``vit_tpu/train/state.py:18-63``).

The JAX state is an immutable pytree that each step replaces; here the
parameters are the model's own tensors and ``apply_gradients`` updates them,
the moments and the step in place (no second copy of the parameters). The
EMA of the JAX state is not ported.

``state_dict`` / ``load_state_dict`` carry the state to and from a
checkpoint (``train/checkpoint.py``): the step, the parameters by the
model's own names, and the optimizer's count and moments (μ in its own
dtype, bf16 by default).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

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

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> "TrainState":
        """One optimizer step on ``params`` (in place); returns ``self``."""
        self.tx.update_(self.params, grads, self.opt_state)
        self.step += 1
        return self

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer) -> "TrainState":
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        params = [p for _, p in named]
        return cls(step=torch.zeros((), dtype=torch.int64,
                                    device=params[0].device),
                   params=params, opt_state=tx.init(params), tx=tx,
                   names=[n for n, _ in named])

    def state_dict(self) -> dict:
        """The step, ``{"params": {name: tensor}}`` and the optimizer
        state, as the live tensors (no copies)."""
        return {"step": self.step,
                "params": dict(zip(self.names, self.params)),
                "opt_state": self.opt_state.state_dict(self.names)}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> "TrainState":
        """Copy a ``state_dict`` into this state in place. Raises unless the
        names, shapes and dtypes are this state's."""
        check_named(sd["params"], dict(zip(self.names, self.params)), "params")
        for name, p in zip(self.names, self.params):
            p.copy_(sd["params"][name])
        self.step.copy_(sd["step"])
        self.opt_state.load_state_dict(sd["opt_state"], self.names)
        return self


def param_count(params: Sequence[torch.Tensor]) -> int:
    """Total parameter count (reference utils.py:3)."""
    return sum(p.numel() for p in params)


def params_str(params: Sequence[torch.Tensor]) -> str:
    return f"{param_count(params) / 1e6:.1f}M"
