"""Train state: the model's parameters, the optimizer state and the step
(counterpart of ``vit_tpu/train/state.py:18-55``).

The JAX state is an immutable pytree that each step replaces; here the
parameters are the model's own tensors and ``apply_gradients`` updates them,
the moments and the step in place (no second copy of the parameters). The
EMA of the JAX state is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from vit_tpu_torch.train.optim import Optimizer, OptState


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor                 # int64, on the parameters' device
    params: "list[torch.Tensor]"       # the model's trainable parameters
    opt_state: OptState
    tx: Optimizer

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> "TrainState":
        """One optimizer step on ``params`` (in place); returns ``self``."""
        self.tx.update_(self.params, grads, self.opt_state)
        self.step += 1
        return self

    @classmethod
    def create(cls, model: nn.Module, tx: Optimizer) -> "TrainState":
        params = [p for p in model.parameters() if p.requires_grad]
        return cls(step=torch.zeros((), dtype=torch.int64,
                                    device=params[0].device),
                   params=params, opt_state=tx.init(params), tx=tx)
