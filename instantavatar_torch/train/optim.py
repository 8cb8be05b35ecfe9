"""Optimizer: grouped Adam with the step-wise polynomial epoch decay, the
frozen field of the refine flow and the skip of non-finite updates.

Port of ``instantavatar_tpu/train/optim.py``: the ``field`` group is a
``torch.optim.Adam`` (betas (0.9, 0.99), eps 1e-15) whose learning rate
is ``lr * (1 - epoch / max_epochs) ** 1.5`` with epoch = count //
steps_per_epoch, count being the number of updates applied so far (the
count optax's schedule reads); the ``smpl`` group gets its own Adam at
``smpl_lr`` (no decay), or no update when ``smpl_lr`` is None. With
``freeze_field`` (JAX's ``optax.set_to_zero()`` on the field group, which
the refine flow sets) the field group has no Adam: its parameters stay
bit-identical and keep no moments.

``skip_nonfinite`` copies ``optax.apply_if_finite(inner,
max_consecutive_errors=skip_nonfinite)``: a step whose gradients are not
all finite is skipped (parameters, moments and count stay), unless more
than ``skip_nonfinite`` such steps came in a row, in which case the update
is applied as it is (non-finite values included), as optax does. A finite
step resets the run. Parameters without a gradient take a zero gradient,
so their moments decay as optax's do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["poly_decay_schedule", "make_optimizer", "OptimizerSpec",
           "GroupedAdam"]


def poly_decay_schedule(base_lr: float, max_epochs: int,
                        steps_per_epoch: int, power: float = 1.5
                        ) -> Callable[[int], float]:
    def schedule(count: int) -> float:
        epoch = min(count // max(steps_per_epoch, 1), max_epochs - 1)
        return base_lr * (1.0 - epoch / max_epochs) ** power
    return schedule


@dataclass(frozen=True)
class OptimizerSpec:
    """What to build; ``init`` binds it to parameters."""
    lr: float = 1e-2
    smpl_lr: float | None = None
    max_epochs: int | None = None
    steps_per_epoch: int = 100
    freeze_field: bool = False
    betas: tuple[float, float] = (0.9, 0.99)
    eps: float = 1e-15
    skip_nonfinite: int = 10

    def field_lr(self, count: int) -> float:
        if self.max_epochs is None:
            return self.lr
        return poly_decay_schedule(self.lr, self.max_epochs,
                                   self.steps_per_epoch)(count)

    def init(self, groups: dict[str, list[torch.Tensor]]) -> "GroupedAdam":
        return GroupedAdam(self, groups)


def make_optimizer(lr: float = 1e-2, smpl_lr: float | None = None, *,
                   max_epochs: int | None = None, steps_per_epoch: int = 100,
                   freeze_field: bool = False,
                   betas: tuple[float, float] = (0.9, 0.99),
                   eps: float = 1e-15,
                   skip_nonfinite: int = 10) -> OptimizerSpec:
    """The grouped optimizer over ``{"field": [...], "smpl": [...]}``."""
    return OptimizerSpec(lr, smpl_lr, max_epochs, steps_per_epoch,
                         freeze_field, tuple(betas), eps, skip_nonfinite)


class GroupedAdam:
    """An ``OptimizerSpec`` bound to parameter groups: reads ``p.grad``
    and updates the parameters in place."""

    def __init__(self, spec: OptimizerSpec,
                 groups: dict[str, list[torch.Tensor]]):
        self.spec = spec
        self.params = [p for g in groups.values() for p in g]
        field, smpl = list(groups.get("field", ())), list(groups.get("smpl",
                                                                     ()))
        adam = dict(betas=spec.betas, eps=spec.eps)
        self.field = (torch.optim.Adam(field, lr=spec.field_lr(0), **adam)
                      if field and not spec.freeze_field else None)
        self.smpl = (torch.optim.Adam(smpl, lr=spec.smpl_lr, **adam)
                     if smpl and spec.smpl_lr is not None else None)
        self.count = 0             # updates applied (the schedule's count)
        self.notfinite_count = 0   # non-finite steps in a row

    def step(self) -> bool:
        """Apply one update from the parameters' gradients; returns
        whether it was applied."""
        grads = [p.grad for p in self.params if p.grad is not None]
        finite = (not grads or bool(torch.stack(
            [torch.isfinite(g).all() for g in grads]).all()))
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not (finite or not self.spec.skip_nonfinite
                or self.notfinite_count > self.spec.skip_nonfinite):
            return False
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.field is not None:
            for g in self.field.param_groups:
                g["lr"] = self.spec.field_lr(self.count)
            self.field.step()
        if self.smpl is not None:
            self.smpl.step()
        self.count += 1
        return True

    def moments(self, group: str = "field"
                ) -> tuple[list[torch.Tensor], list[torch.Tensor]] | None:
        """The group's Adam moments in parameter order, or None before its
        first update (or for a group without an Adam)."""
        opt = getattr(self, group)
        if opt is None:
            return None
        st = [opt.state.get(p) for p in opt.param_groups[0]["params"]]
        if not all(s and "exp_avg" in s for s in st):
            return None
        return [s["exp_avg"] for s in st], [s["exp_avg_sq"] for s in st]

    def load_moments(self, mu: list[torch.Tensor], nu: list[torch.Tensor],
                     count: int, group: str = "field") -> None:
        """Set a group's Adam moments (in parameter order) and the update
        count, e.g. from an optax state."""
        opt = getattr(self, group)
        for p, m, v in zip(opt.param_groups[0]["params"], mu, nu,
                           strict=True):
            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": m.to(p).clone(), "exp_avg_sq": v.to(p).clone()}
        self.count = count
