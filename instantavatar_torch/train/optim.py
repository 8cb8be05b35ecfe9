"""Optimizer: grouped Adam with the step-wise polynomial epoch decay, the
frozen field of the refine flow and the skip of non-finite updates.

Port of ``instantavatar_tpu/train/optim.py``: the ``field`` group is
optax's Adam (betas (0.9, 0.99), eps 1e-15) whose learning rate is ``lr * (1 - epoch / max_epochs) ** 1.5`` with epoch = count //
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
so their moments decay as optax's do. As in optax, every decision is made
on the device (see ``GroupedAdam``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["poly_decay_schedule", "make_optimizer", "OptimizerSpec",
           "GroupedAdam"]


def poly_decay_schedule(base_lr: float, max_epochs: int,
                        steps_per_epoch: int, power: float = 1.5
                        ) -> Callable:
    """count -> lr; a count tensor gives an lr tensor on its device."""
    def schedule(count):
        epoch = count // max(steps_per_epoch, 1)
        epoch = (epoch.clamp(max=max_epochs - 1).float()
                 if torch.is_tensor(epoch) else min(epoch, max_epochs - 1))
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


class _AdamGroup:
    """One group's Adam moments, zero at bind time, laid out as
    ``torch.optim.Adam`` keeps them (``param_groups[0]["params"]``,
    ``state[p]["exp_avg"]``/``["exp_avg_sq"]``)."""

    def __init__(self, params: list[torch.Tensor]):
        self.params = params
        self.exp_avg = [torch.zeros_like(p) for p in params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in params]

    @property
    def param_groups(self) -> list[dict]:
        return [{"params": self.params}]

    @property
    def state(self) -> dict:
        return {p: {"exp_avg": m, "exp_avg_sq": v} for p, m, v in
                zip(self.params, self.exp_avg, self.exp_avg_sq)}

    def update(self, grads: list[torch.Tensor], lr, t: torch.Tensor,
               apply: torch.Tensor, betas: tuple[float, float],
               eps: float) -> None:
        """optax's ``scale_by_adam`` then ``scale_by_learning_rate`` at
        count ``t`` (after its increment), written where ``apply``."""
        b1, b2 = betas
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for p, g, m, v in zip(self.params, grads, self.exp_avg,
                              self.exp_avg_sq):
            m_new = (1.0 - b1) * g + b1 * m
            v_new = (1.0 - b2) * (g * g) + b2 * v
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            m.copy_(torch.where(apply, m_new, m))
            v.copy_(torch.where(apply, v_new, v))
            p.copy_(torch.where(apply, p + u * -lr, p))


class GroupedAdam:
    """An ``OptimizerSpec`` bound to parameter groups: reads ``p.grad``
    and updates the parameters in place.

    Everything the update decides stays on the parameters' device, as in
    optax: the update count and the run of non-finite steps are int64
    tensors, the finite gate a device bool that selects between the
    updated and the old parameters and moments, and the decayed learning
    rate a tensor computed from the count. ``step`` reads nothing back
    to the host, so it can be captured in a CUDA graph."""

    def __init__(self, spec: OptimizerSpec,
                 groups: dict[str, list[torch.Tensor]]):
        self.spec = spec
        self.params = [p for g in groups.values() for p in g]
        field, smpl = list(groups.get("field", ())), list(groups.get("smpl",
                                                                     ()))
        self.field = (_AdamGroup(field)
                      if field and not spec.freeze_field else None)
        self.smpl = (_AdamGroup(smpl)
                     if smpl and spec.smpl_lr is not None else None)
        dev = self.params[0].device if self.params else None
        # updates applied (the schedule's count), non-finite steps in a row
        self._count = torch.zeros((), dtype=torch.int64, device=dev)
        self._notfinite = torch.zeros((), dtype=torch.int64, device=dev)

    @property
    def count(self) -> torch.Tensor:
        return self._count

    @count.setter
    def count(self, value) -> None:
        self._count.fill_(int(value))

    @property
    def notfinite_count(self) -> torch.Tensor:
        return self._notfinite

    @notfinite_count.setter
    def notfinite_count(self, value) -> None:
        self._notfinite.fill_(int(value))

    def field_lr(self) -> torch.Tensor | float:
        """The field group's learning rate at the current count:
        ``poly_decay_schedule`` on the device."""
        spec = self.spec
        if spec.max_epochs is None:
            return spec.lr
        return poly_decay_schedule(spec.lr, spec.max_epochs,
                                   spec.steps_per_epoch)(self._count)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' gradients; returns a
        device bool, whether it was applied."""
        spec = self.spec
        finite = torch.ones((), dtype=torch.bool, device=self._count.device)
        for p in self.params:
            if p.grad is not None:
                finite = finite & torch.isfinite(p.grad).all()
        self._notfinite.copy_(torch.where(finite, 0, self._notfinite + 1))
        apply = (finite | (self._notfinite > spec.skip_nonfinite)
                 if spec.skip_nonfinite else torch.ones_like(finite))
        t = (self._count + 1).float()
        for group, lr in ((self.field, self.field_lr()),
                          (self.smpl, spec.smpl_lr)):
            if group is not None:
                group.update([torch.zeros_like(p) if p.grad is None
                              else p.grad for p in group.params], lr, t,
                             apply, spec.betas, spec.eps)
        self._count.add_(apply.long())
        return apply

    def moments(self, group: str = "field"
                ) -> tuple[list[torch.Tensor], list[torch.Tensor]] | None:
        """The group's Adam moments in parameter order (zero before its
        first update), or None for a group without an Adam."""
        opt = getattr(self, group)
        if opt is None:
            return None
        return opt.exp_avg, opt.exp_avg_sq

    def load_moments(self, mu: list[torch.Tensor], nu: list[torch.Tensor],
                     count: int, group: str = "field") -> None:
        """Set a group's Adam moments (in parameter order) and the update
        count, e.g. from an optax state; the tensors keep their storage."""
        opt = getattr(self, group)
        for p, m, v, m_to, v_to in zip(opt.params, mu, nu, opt.exp_avg,
                                       opt.exp_avg_sq, strict=True):
            m_to.copy_(m.reshape(p.shape))
            v_to.copy_(v.reshape(p.shape))
        self.count = count
