"""Adam with the step-wise polynomial epoch decay and the skip of
non-finite updates (optax's ``adam`` under ``apply_if_finite``): the
learning rate is ``lr * (1 - epoch / max_epochs) ** 1.5`` with epoch =
count // steps_per_epoch, count being the updates applied so far. A step
whose gradients are not all finite is skipped (parameters, moments and
count stay), unless more than ``skip_nonfinite`` such steps came in a
row. Parameters without a gradient take a zero gradient."""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["make_optimizer", "OptimizerSpec", "GroupedAdam"]


@dataclass(frozen=True)
class OptimizerSpec:
    """What to build; ``init`` binds it to parameters."""
    lr: float = 1e-2
    max_epochs: int | None = None
    steps_per_epoch: int = 100
    betas: tuple[float, float] = (0.9, 0.99)
    eps: float = 1e-15
    skip_nonfinite: int = 10

    def init(self, params: list[torch.Tensor]) -> "GroupedAdam":
        return GroupedAdam(self, params)


def make_optimizer(lr: float = 1e-2, *, max_epochs: int | None = None,
                   steps_per_epoch: int = 100,
                   betas: tuple[float, float] = (0.9, 0.99),
                   eps: float = 1e-15,
                   skip_nonfinite: int = 10) -> OptimizerSpec:
    return OptimizerSpec(lr, max_epochs, steps_per_epoch, tuple(betas), eps,
                         skip_nonfinite)


class GroupedAdam:
    """An ``OptimizerSpec`` bound to the field's parameters: reads
    ``p.grad`` and updates the parameters in place."""

    def __init__(self, spec: OptimizerSpec, params: list[torch.Tensor]):
        self.spec = spec
        self.params = params
        self.exp_avg = [torch.zeros_like(p) for p in params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in params]
        dev = params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.notfinite = torch.zeros((), dtype=torch.int64, device=dev)

    def lr(self) -> torch.Tensor | float:
        spec = self.spec
        if spec.max_epochs is None:
            return spec.lr
        epoch = (self.count // max(spec.steps_per_epoch, 1)) \
            .clamp(max=spec.max_epochs - 1).float()
        return spec.lr * (1.0 - epoch / spec.max_epochs) ** 1.5

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update; returns whether it was applied."""
        spec = self.spec
        finite = torch.ones((), dtype=torch.bool, device=self.count.device)
        for p in self.params:
            if p.grad is not None:
                finite = finite & torch.isfinite(p.grad).all()
        self.notfinite.copy_(torch.where(finite, 0, self.notfinite + 1))
        apply = (finite | (self.notfinite > spec.skip_nonfinite)
                 if spec.skip_nonfinite else torch.ones_like(finite))
        t = (self.count + 1).float()
        lr = self.lr()
        b1, b2 = spec.betas
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for p, m, v in zip(self.params, self.exp_avg, self.exp_avg_sq):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            m_new = (1.0 - b1) * g + b1 * m
            v_new = (1.0 - b2) * (g * g) + b2 * v
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + spec.eps)
            m.copy_(torch.where(apply, m_new, m))
            v.copy_(torch.where(apply, v_new, v))
            p.copy_(torch.where(apply, p + u * -lr, p))
        self.count.add_(apply.long())
        return apply
