"""The training step as captured CUDA graphs: JAX's one compiled program
per step, on the card.

JAX jits ``train_step``/``train_step_update`` and scans K of them in
``train_multi_step``, taking the grid-update branch with ``lax.cond`` on
the device's step counter (``instantavatar_tpu/train/model.py:704-755``).
Here each step is one replay of a CUDA graph that holds the whole step:
the frame bake, the grid sweep, the warp-cache bake, the render, the
loss, autograd and the optimizer update. The host knows the step, so it
picks the graph: one per ``AvatarModel.graph_key`` (grid update or not,
the 500-step latch and the regularizer's warm-up, sigma noise on or
off), each captured at its first use and sharing one memory pool.

A replay reads and writes fixed addresses, so ``StepGraphs`` keeps:

  * static input buffers, one per batch key and one per draw, into which
    ``run`` copies each step's batch and draws (stream-ordered, no host
    sync) before the replay;
  * the state's own tensors: the field parameters, the Adam moments and
    counts (updated in place by ``GroupedAdam.step``), the grid (written
    in place by ``grads_and_losses(in_place=True)``), the canonical bake,
    the normalization and the SMPL leaves. Their addresses are the
    graphs' signature; a state whose tensors were replaced (``init``,
    ``restore_checkpoint``, ``graft``, or an eager step's new grid)
    drops the graphs, and the next step captures anew;
  * the losses, stacked into one tensor of the pool, cloned out after
    each replay (before the next can overwrite them).

Before each capture the step runs once eagerly on the capture stream
(cuBLAS, cuDNN, NCCL and the head's library initialise there), without
the optimizer and without writing the grid, so the state does not
advance.
The fused head's counters count at capture, when nothing runs: the
launches and rows captured into each graph are added on each replay.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass

import torch

from ..kernels.fused_head import fused_field_head
from .model import StepDraws, TrainState

__all__ = ["StepGraphs", "step_body"]


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    losses: torch.Tensor       # (n,) in the pool: the step's loss values
    names: tuple[str, ...]
    launches: int              # fused-head launches and rows per replay
    rows: int


def _state_tensors(state: TrainState, model) -> list[torch.Tensor]:
    """Every tensor of the state that a captured step reads or writes."""
    out = list(model.field.parameters()) + list(state.grid)
    out += [state.center, state.scale]
    out += [t for t in state.deformer_cano if torch.is_tensor(t)]
    out += list(state.smpl or ())
    opt = state.opt_state
    out += [opt.count, opt.notfinite_count]
    for group in ("field", "smpl"):
        mom = opt.moments(group)
        if mom is not None:
            out += mom[0] + mom[1]
    return out


def _layout(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype)


def step_body(model, state: TrainState, batch: dict, draws: StepDraws,
              update: bool, reduce=None) -> dict:
    """The captured step: ``grads_and_losses(in_place=True)``, the ray
    group's ``reduce`` hook (``(group, fn)``, ``fn(params, losses, grid,
    update) -> (losses, grid)``, writing the averages in place) when
    given, then the optimizer. Returns the losses."""
    losses, grid = model.grads_and_losses(state, batch, draws, update,
                                          in_place=True)
    if reduce is not None:
        losses, _ = reduce[1](state.opt_state.params, losses, grid, update)
    state.opt_state.step()
    return losses


class StepGraphs:
    """One model's captured training steps (see the module docstring).
    ``captures`` counts the graphs captured, ``capture_seconds`` the
    host time they took (warm-up included)."""

    def __init__(self, model):
        # the model owns this object: a weak reference back, so that the
        # model and its graphs' memory go when the model's last user does
        # (a reference cycle would keep them until a full gc pass)
        self._model = weakref.ref(model)
        self.device = model.device
        self.stream = torch.cuda.Stream(self.device)
        self.captures = 0
        self.capture_seconds = 0.0
        self._reset(None)

    @property
    def model(self):
        return self._model()

    def _reset(self, signature) -> None:
        self.signature = signature
        self.graphs: dict[tuple, _Graph] = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.batch: dict[str, torch.Tensor] = {}
        self.draws: dict[str, torch.Tensor] = {}

    def _signature(self, state: TrainState, batch: dict,
                   draws: StepDraws) -> tuple:
        return (tuple(_layout(t) for t in
                      _state_tensors(state, self.model)),
                tuple((k, tuple(v.shape), v.dtype)
                      for k, v in sorted(batch.items())),
                tuple(tuple(v.shape) for v in
                      (draws.jitter, draws.noise)))

    def _stage(self, state: TrainState, batch: dict,
               draws: StepDraws) -> None:
        """Copy the step's batch and draws into the static buffers,
        re-making them (and dropping the graphs) when the state's tensors
        or the inputs' shapes changed."""
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        sig = self._signature(state, batch, draws)
        if sig != self.signature:
            self._reset(sig)
        for k, v in batch.items():
            if k not in self.batch:
                self.batch[k] = torch.empty(v.shape, dtype=v.dtype,
                                            device=self.device)
            self.batch[k].copy_(v, non_blocking=True)
        for k, v in draws._asdict().items():
            if v is None:
                continue
            if k not in self.draws:
                self.draws[k] = torch.empty_like(v, device=self.device)
            self.draws[k].copy_(v, non_blocking=True)

    def _static_draws(self, update: bool) -> StepDraws:
        d = self.draws
        return StepDraws(d["jitter"], d["noise"],
                         d["grid_jitter"] if update else None)

    def key(self, state: TrainState, update: bool | None = None,
            reduce=None) -> tuple:
        """The graph of a step: its ``graph_key`` (the grid update taken
        from ``update`` when given, else from the cadence) and its ray
        group (None without a reduce)."""
        return (self.model.graph_key(state.step, update),
                None if reduce is None else reduce[0])

    def _capture(self, state: TrainState, key: tuple, reduce=None
                 ) -> _Graph:
        model, update = self.model, key[0][0]
        draws = self._static_draws(update)
        t0 = time.perf_counter()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            # warm-up: the step's kernels once (and the ray group's
            # all_reduce, whose first call makes the NCCL communicator),
            # the state left as it is: the grid is not reduced
            losses, grid = model.grads_and_losses(state, self.batch, draws,
                                                  update)
            if reduce is not None:
                reduce[1](state.opt_state.params, losses, grid, False)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        launches, rows = fused_field_head.launches, fused_field_head.rows
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            losses = step_body(model, state, self.batch, draws, update,
                               reduce)
            names = tuple(losses)
            stacked = torch.stack([losses[k].float() for k in names])
        captured = _Graph(graph, stacked, names,
                          fused_field_head.launches - launches,
                          fused_field_head.rows - rows)
        # the capture launched nothing: the replays count
        fused_field_head.launches, fused_field_head.rows = launches, rows
        self.graphs[key] = captured
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return captured

    def run(self, state: TrainState, batch: dict, draws: StepDraws, *,
            update: bool | None = None, reduce=None
            ) -> tuple[TrainState, dict]:
        """One training step as one graph replay; returns (the state one
        step on, the step's losses). ``update`` (default: the cadence)
        says whether the step updates the grid; ``reduce`` is the ray
        group's hook (see ``step_body``)."""
        self._stage(state, batch, draws)
        key = self.key(state, update, reduce)
        g = self.graphs.get(key) or self._capture(state, key, reduce)
        g.graph.replay()
        fused_field_head.launches += g.launches
        fused_field_head.rows += g.rows
        losses = g.losses.clone()
        return (state._replace(step=state.step + 1),
                dict(zip(g.names, losses.unbind(0))))
