"""Adam over the fit's two groups, plain (upstream's optimizer of the fit:
Adam on the field's parameters at ``lr`` with the epoch-wise polynomial
decay, and on the per-frame SMPL parameters at their own constant
``pose_lr``; optax's update under ``apply_if_finite``, as the frozen
plain optimizer has it):

    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
    p -= lr_t * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

with t the updates applied so far plus one, lr_t = lr * (1 - epoch /
max_epochs) ** 1.5 for the field (epoch = applied // steps_per_epoch)
and ``pose_lr`` for the SMPL leaves. A step whose gradients, of either
group, are not all finite changes nothing, unless more than
``skip_nonfinite`` such steps came in a row. A parameter without a
gradient takes a zero one. ``frozen=("pose",)`` leaves that group's
parameters and moments as they are (a fault of the benchmark's).

Nothing here imports the program, JAX or the JAX package.
"""
from __future__ import annotations

import torch

__all__ = ["FitAdam"]


class FitAdam:
    def __init__(self, groups: dict[str, list[torch.Tensor]], *,
                 lr: float, pose_lr: float, max_epochs: int,
                 steps_per_epoch: int, betas=(0.9, 0.99), eps: float = 1e-15,
                 skip_nonfinite: int = 10, frozen: tuple = ()):
        self.groups = groups
        self.lr, self.pose_lr = lr, pose_lr
        self.max_epochs, self.steps_per_epoch = max_epochs, steps_per_epoch
        self.betas, self.eps = tuple(betas), eps
        self.skip_nonfinite = skip_nonfinite
        self.frozen = frozen
        self.m = {k: [torch.zeros_like(p) for p in ps]
                  for k, ps in groups.items()}
        self.v = {k: [torch.zeros_like(p) for p in ps]
                  for k, ps in groups.items()}
        dev = groups["field"][0].device
        self.applied = torch.zeros((), dtype=torch.int64, device=dev)
        self.bad_run = torch.zeros((), dtype=torch.int64, device=dev)

    def group_lr(self, name: str):
        if name == "pose":
            return self.pose_lr
        epoch = (self.applied // self.steps_per_epoch).clamp(
            max=self.max_epochs - 1).float()
        return self.lr * (1.0 - epoch / self.max_epochs) ** 1.5

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        every = [p for ps in self.groups.values() for p in ps]
        finite = torch.ones((), dtype=torch.bool, device=self.applied.device)
        for p in every:
            if p.grad is not None:
                finite &= torch.isfinite(p.grad).all()
        self.bad_run = torch.where(finite, 0, self.bad_run + 1)
        apply = finite | (self.bad_run > self.skip_nonfinite)
        t = (self.applied + 1).float()
        b1, b2 = self.betas
        for name, ps in self.groups.items():
            if name in self.frozen:
                continue
            lr = self.group_lr(name)
            for p, m, v in zip(ps, self.m[name], self.v[name]):
                g = torch.zeros_like(p) if p.grad is None else p.grad
                m_new = b1 * m + (1.0 - b1) * g
                v_new = b2 * v + (1.0 - b2) * (g * g)
                upd = (m_new / (1.0 - b1 ** t)) / (
                    torch.sqrt(v_new / (1.0 - b2 ** t)) + self.eps)
                m.copy_(torch.where(apply, m_new, m))
                v.copy_(torch.where(apply, v_new, v))
                p.copy_(torch.where(apply, p - lr * upd, p))
        self.applied += apply.long()
        return apply
