"""Train state: the model's parameters, the optimizer state and the EMA (port
of sylph_tpu/train/train_state.py).

The JAX package carries a functional pytree; here the model owns the
parameters, ``SGD`` the momentum and count, and ``TrainState`` the EMA,
updated after each optimizer update as ``e * d + p * (1 - d)`` over every
parameter (frozen ones included, as the JAX EMA tree holds every leaf).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from .optimizer import SGD


class TrainState:
    def __init__(self, model: nn.Module, tx: SGD, use_ema: bool = False,
                 ema_decay: float = 0.9998):
        self.model = model
        self.tx = tx
        self.ema_decay = float(ema_decay)
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if use_ema:
            self.ema = {n: p.detach().clone()
                        for n, p in model.named_parameters()}

    @property
    def step(self) -> int:
        return self.tx.count

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @torch.no_grad()
    def apply_updates(self) -> None:
        """One optimizer update from the gradients in ``.grad``, then the
        EMA."""
        self.tx.step()
        if self.ema is not None:
            d = self.ema_decay
            names = list(self.ema)
            ema = [self.ema[n] for n in names]
            params = self.params
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, torch._foreach_mul(
                [params[n].detach() for n in names], 1.0 - d))

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resume needs, on the CPU: the model's state_dict
        (parameters and FrozenBN buffers), the optimizer and the EMA."""
        return {"step": self.step,
                "model": {k: v.detach().cpu()
                          for k, v in self.model.state_dict().items()},
                "tx": self.tx.state_dict(),
                "ema": (None if self.ema is None else
                        {k: v.detach().cpu() for k, v in self.ema.items()})}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.tx.load_state_dict(sd["tx"])
        if self.ema is not None and sd.get("ema") is not None:
            for k, v in self.ema.items():
                v.copy_(sd["ema"][k])
