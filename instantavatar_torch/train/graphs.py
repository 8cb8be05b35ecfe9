"""A model's device programs as captured CUDA graphs: JAX's jitted
training step (``train_step``/``train_multi_step``), its one-program
frame (``_render_frame_fused``, the ray-sharded ``make_dp_render``) and
its jitted grid builds (``build_pose_grid``, ``build_test_grid``;
``instantavatar_tpu/train/model.py:704-835``, ``:1523``) on the card.

The host knows each call's branches, shapes and budgets, so it picks the
graph by a key; each graph is captured at its first use, and one owner's
graphs share one memory pool. ``Graphs`` is the mechanism; three owners
use it, each saying what it stages, its key, its signature and its
outputs:

  * ``StepGraphs``: the whole training step (``step_body``: the frame
    bake, the grid sweep, the warp-cache bake, the render, the loss,
    autograd, the ray group's reduce and the optimizer), one graph per
    (``AvatarModel.graph_key``, ray group). Before its capture the step
    runs once eagerly without the optimizer and without writing the
    grid, so the state does not advance. The losses are stacked into
    one tensor of the pool.
  * ``FrameGraphs``: the model's frame programs (``_flat_frame``,
    ``_rays_frame``, ``_eval_render``), one graph per (program, image
    shape, budgets, bake or reuse, table set, input shapes). A bake graph
    writes the session's warp-cache tables in place and a reuse graph
    reads them: graphs are kept for the last ``TABLE_SETS`` table sets.
  * ``GridGraphs``: ``_pose_grid`` and ``_test_grid``, one graph per grid
    kind and input shapes; the test grid's jitter holds the default draw
    unless the caller passes one.

A replay reads and writes fixed addresses. So each call's inputs are
copied into static buffers (one per name, shape and dtype; stream-ordered,
no host sync) before the replay, and the outputs are copied out after it,
before the next replay can overwrite them. The state's tensors are read
where they live: the parameters, the Adam moments and counts (updated in
place by ``GroupedAdam.step``), the grid (written in place by the step),
the canonical bake, the normalization and the SMPL leaves, so an
optimizer's in-place update needs no new capture. Their addresses, the
field's head hook and the knobs the program reads are a graph's
signature, stored with it: a graph called under another signature is
captured anew. The step and the frame owners drop all their graphs and
buffers (``clear``) when their signature changes (``init``,
``restore_checkpoint``, ``graft``, an eager step's new grid).

Before each capture the program, or the owner's warm-up, runs once
eagerly on the capture stream (cuBLAS, cuDNN, NCCL and the head's
library initialise there). The counters of ``GRAPH_COUNTED`` (the
kernels and the LPIPS trunk) count at capture, when nothing runs: the
launches and rows captured into each graph are added on each replay
(``kernels/counters.py``).
"""
from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from ..kernels.counters import COUNTED, add_replay, captured_counts
from ..losses.lpips import LPIPS
from ..render.density_grid import DensityGridState
from ..utils.profiling import span

__all__ = ["GRAPH_COUNTED", "Graphs", "StepGraphs", "FrameGraphs",
           "GridGraphs", "step_body", "TABLE_SETS"]

# what a capture counts: the kernels and the LPIPS trunk, which the fit's
# loss calls inside a step (0 in frames and grids)
GRAPH_COUNTED = (*COUNTED, LPIPS)


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    out: Any                   # what the program returned, in the pool
    signature: tuple
    launched: list             # each GRAPH_COUNTED's (launches, rows)
                               # per replay


def _layout(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype)


class Graphs:
    """One model's captured programs of one kind (see the module
    docstring): the capture stream, the pool and the static input
    buffers. ``captures`` counts the graphs captured, ``capture_seconds``
    the host time they took (warm-ups included), ``replays`` the
    replays. The spans are ``<kind>.capture`` and ``<kind>.replay``."""

    def __init__(self, model, kind: str):
        # the model owns this object: a weak reference back, so that the
        # model and its graphs' memory go when the model's last user does
        # (a reference cycle would keep them until a full gc pass)
        self._model = weakref.ref(model)
        self.device = model.device
        self.stream = torch.cuda.Stream(self.device)
        self._spans = (f"{kind}.capture", f"{kind}.replay")
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.clear()

    @property
    def model(self):
        return self._model()

    def clear(self) -> None:
        """Drop every graph and input buffer; a new pool."""
        self.graphs: dict[Any, _Graph] = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.inputs: dict[tuple, torch.Tensor] = {}

    def stage(self, name, value, fp32: bool = False) -> torch.Tensor:
        """Copy ``value`` into the static buffer of its name, shape and
        dtype (float32 for a floating ``value`` with ``fp32``), made at
        first sight; returns the buffer."""
        v = torch.as_tensor(value)
        dtype = torch.float32 if fp32 and v.is_floating_point() else v.dtype
        key = (name, tuple(v.shape), dtype)
        buf = self.inputs.get(key)
        if buf is None:
            buf = self.inputs[key] = torch.empty(v.shape, dtype=dtype,
                                                 device=self.device)
        buf.copy_(v, non_blocking=True)
        return buf

    def _capture(self, key, signature: tuple, program: Callable,
                 warm_up: Callable) -> _Graph:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            warm_up()
        current.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        with captured_counts(GRAPH_COUNTED) as launched, torch.cuda.graph(
                graph, pool=self.pool, stream=self.stream):
            out = program()
        g = self.graphs[key] = _Graph(graph, out, signature, launched)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return g

    def replay(self, key, signature: tuple, program: Callable,
               warm_up: Callable | None = None, tag: str | None = None):
        """One replay of the graph ``key`` of ``program`` (a function of
        no arguments that reads the static buffers), captured first if
        there is none under ``signature``, after ``warm_up`` (default:
        the program) on the capture stream. Returns the program's outputs
        in the pool."""
        g = self.graphs.get(key)
        if g is None or g.signature != signature:
            self.graphs.pop(key, None)   # its memory back to the pool
            with span(self._spans[0]):
                g = self._capture(key, signature, program,
                                  warm_up or program)
        with span(self._spans[1], tag=tag, device=True):
            g.graph.replay()
        self.replays += 1
        add_replay(g.launched, GRAPH_COUNTED)
        return g.out


# -- the training step --------------------------------------------------------

def _state_tensors(state, model) -> list[torch.Tensor]:
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


def step_body(model, state, batch: dict, draws, update: bool,
              reduce=None) -> dict:
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


class StepGraphs(Graphs):
    """One model's captured training steps (see the module docstring)."""

    def __init__(self, model):
        super().__init__(model, "step")
        self.signature = None

    def key(self, state, update: bool | None = None, reduce=None) -> tuple:
        """The graph of a step: its ``graph_key`` (the grid update taken
        from ``update`` when given, else from the cadence) and its ray
        group (None without a reduce)."""
        return (self.model.graph_key(state.step, update),
                None if reduce is None else reduce[0])

    def run(self, state, batch: dict, draws, *, update: bool | None = None,
            reduce=None) -> tuple:
        """One training step as one graph replay; returns (the state one
        step on, the step's losses). ``update`` (default: the cadence)
        says whether the step updates the grid; ``reduce`` is the ray
        group's hook (see ``step_body``)."""
        model = self.model
        with span("step.signature"):
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
            sig = (tuple(_layout(t) for t in _state_tensors(state, model)),
                   tuple((k, tuple(v.shape), v.dtype)
                         for k, v in sorted(batch.items())),
                   tuple(tuple(v.shape) for v in (draws.jitter,
                                                   draws.noise)))
            if sig != self.signature:
                self.clear()
                self.signature = sig
        with span("step.stage"):
            sbatch = {k: self.stage(k, v) for k, v in batch.items()}
            # the grid jitter is drawn for update steps only
            sdraws = draws._replace(**{
                k: self.stage(("draws", k), v)
                for k, v in draws._asdict().items() if v is not None})
        key = self.key(state, update, reduce)
        update = key[0][0]

        def program():
            losses = step_body(model, state, sbatch, sdraws, update, reduce)
            return tuple(losses), torch.stack([losses[k].float()
                                               for k in losses])

        def warm_up():
            # the step's kernels once (and the ray group's all_reduce,
            # whose first call makes the NCCL communicator), the state
            # left as it is: the grid is not reduced
            losses, grid = model.grads_and_losses(state, sbatch, sdraws,
                                                  update)
            if reduce is not None:
                reduce[1](state.opt_state.params, losses, grid, False)

        names, stacked = self.replay(key, self.signature, program, warm_up,
                                     "update" if update else "plain")
        with span("step.losses"):
            losses = dict(zip(names, stacked.clone().unbind(0)))
        return state._replace(step=state.step + 1), losses


# -- the frames ---------------------------------------------------------------

_POSE = ("betas", "body_pose", "global_orient", "transl")
_GRID = ("density_cached", "occupancy", "aabb")
# the batch inputs that each frame program reads
INPUTS = {"_flat_frame": ("ray_basis", *_POSE, "bg_color"),
          "_rays_frame": ("rays_o", "rays_d", *_POSE, "bg_color"),
          "_eval_render": ("rays_o", "rays_d", *_POSE, "bg_color")}
# the model's knobs that the frame programs read
KNOBS = ("grid_size", "cache_n_cand", "term_T", "alpha_skip",
         "shared_corner_eval", "flat_tile_rows", "prepass_steps",
         "prepass_block", "eval_sampling", "use_warp_cache",
         "cache_fused_probe", "n_windows", "eval_n_steps", "k_cap",
         "n_steps", "prepass_dilate", "prepass_margin_steps")
TABLE_SETS = 4


class _Key(NamedTuple):
    program: str
    image_shape: tuple | None
    budgets: tuple        # the program's budgets; cells only when it bakes
    bake: bool | None     # None: no warp cache
    tables: tuple | None  # the table set's key
    layout: tuple         # the staged inputs' names and shapes


class FrameGraphs(Graphs):
    """One model's captured frame programs (see the module docstring)."""

    def __init__(self, model):
        super().__init__(model, "frame")
        self.signature = None

    def clear(self) -> None:
        super().clear()
        self.table_sets: OrderedDict = OrderedDict()

    def _table_set(self, tables: tuple) -> tuple:
        """The tables' key; a new one beyond TABLE_SETS drops the graphs
        of the least recently used table set."""
        tkey = tuple(_layout(t) for t in tables)
        self.table_sets[tkey] = None
        self.table_sets.move_to_end(tkey)
        while len(self.table_sets) > TABLE_SETS:
            old, _ = self.table_sets.popitem(last=False)
            self.graphs = {k: g for k, g in self.graphs.items()
                           if k.tables != old}
        return tkey

    def run(self, program: str, state, batch: dict,
            grid: DensityGridState | None, *args
            ) -> tuple[dict, torch.Tensor | None]:
        """One call of the model's frame program ``program`` as one graph
        replay, with the program's arguments: ``_flat_frame`` (image
        shape, bake plan, sample and cell budgets), ``_rays_frame`` (image
        shape or None, bake plan or None, chunk, ray and cell budgets) or
        ``_eval_render`` (none). Returns copies of its outputs (rgb,
        depth, alpha, counter) and of its counts (None for
        ``_eval_render``)."""
        model = self.model
        with span("frame.stage"):
            field = model.field
            tensors = list(field.parameters()) + [state.center, state.scale]
            tensors += [t for t in state.deformer_cano if torch.is_tensor(t)]
            sig = (tuple(_layout(t) for t in tensors),
                   id(getattr(field, "head_fn", None)),
                   tuple(getattr(model, k) for k in KNOBS))
            if sig != self.signature:
                self.clear()
                self.signature = sig
            vals = {k: batch[k] for k in INPUTS[program]
                    if batch.get(k) is not None}
            if grid is not None:
                vals.update(zip(_GRID, grid))
            sbatch = {k: self.stage(k, v, fp32=True) for k, v in vals.items()}
            layout = tuple((k, tuple(v.shape)) for k, v in sbatch.items())
            sgrid = (None if grid is None else DensityGridState(
                *(sbatch.pop(k) for k in _GRID)))
        image_shape, plan, *budgets = args or (None, None)
        bake = None if plan is None else plan.bake
        if budgets and not bake:
            budgets[-1] = None   # the cell budget of a bake it does not run
        key = _Key(program, image_shape and tuple(image_shape),
                   tuple(budgets), bake,
                   None if plan is None else self._table_set(plan.tables),
                   layout)
        run = getattr(model, program)
        out, counts = self.replay(
            key, self.signature, lambda: run(state, sbatch, sgrid, *args),
            tag="bake" if bake else "reuse")
        with span("frame.outputs"):
            return ({k: v.clone() for k, v in out.items()},
                    None if counts is None else counts.clone())


# -- the per-pose grids -------------------------------------------------------

# the grid builds' inputs, and the model's knobs that each kind reads
GRID_INPUTS = (*_POSE, "idx")
GRID_KNOBS = {"smpl_shell": ("grid_size", "shell_margin"),
              "density": ("grid_size",)}


class GridGraphs(Graphs):
    """One model's captured grid builds (see the module docstring). A
    build's grid is cloned out of the pool, so it is the caller's: the
    next pose's replay cannot overwrite a grid that a queued frame, a
    ``RenderSession`` or a caller still reads."""

    def __init__(self, model):
        super().__init__(model, "grid")
        self.jitter: torch.Tensor | None = None
        self.default_jitter = False   # whether ``jitter`` holds it

    def _signature(self, kind: str, state) -> tuple:
        model = self.model
        tensors = [t for t in state.deformer_cano if torch.is_tensor(t)]
        tensors += list(state.smpl or ())
        head = None
        if kind == "density":
            tensors += list(model.field.parameters())
            tensors += [state.center, state.scale]
            head = id(getattr(model.field, "head_fn", None))
        return (tuple(_layout(t) for t in tensors), head,
                tuple(getattr(model, k) for k in GRID_KNOBS[kind]))

    def _stage_jitter(self, jitter: torch.Tensor | None) -> torch.Tensor:
        """The test grid's jitter buffer, holding ``jitter`` or, for None,
        the default draw (drawn once)."""
        model = self.model
        shape = (5,) + (model.grid_size,) * 3 + (3,)
        if self.jitter is None or tuple(self.jitter.shape) != shape:
            self.jitter = torch.empty(shape, device=self.device)
            self.default_jitter = False
        if jitter is not None:
            self.jitter.copy_(jitter, non_blocking=True)
            self.default_jitter = False
        elif not self.default_jitter:
            self.jitter.copy_(model._default_jitter())
            self.default_jitter = True
        return self.jitter

    def run(self, kind: str, state, batch: dict,
            jitter: torch.Tensor | None = None) -> DensityGridState:
        """One grid build of ``kind`` ("smpl_shell": ``build_pose_grid``,
        "density": ``build_test_grid``) as one graph replay; returns
        copies of the grid's tensors."""
        model = self.model
        with span("grid.stage"):
            staged = {k: self.stage(k, batch[k], fp32=True)
                      for k in GRID_INPUTS if batch.get(k) is not None}
            layout = tuple((k, tuple(v.shape), v.dtype)
                           for k, v in staged.items())
            args = (state, staged)
            if kind == "density":
                args += (self._stage_jitter(jitter),)
        build = model._test_grid if kind == "density" else model._pose_grid
        out = self.replay((kind, layout), self._signature(kind, state),
                          lambda: build(*args), tag=kind)
        return DensityGridState(*(t.clone() for t in out))
