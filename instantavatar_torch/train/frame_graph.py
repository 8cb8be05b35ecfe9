"""The flat eval frame as captured CUDA graphs: JAX's one-program frame
(``_render_frame_fused``) on the card.

JAX jits the whole frame into one program with static shapes, its sample
and cell budgets learned per ``RenderSession``
(``instantavatar_tpu/train/model.py:835``, ``:1523``). Here each flat
frame is one replay of a CUDA graph that holds ``AvatarModel._flat_frame``:
the frame bake, the warp-cache bake at the cell budget (or none, when the
frame reuses the session's tables), the prepass, the flat selection at
the sample budget, the field eval through the fused head and the
composite. The host knows the frame's image shape, its budgets and
whether it bakes, so it picks the graph: one per (H, W, p, samp_budget,
cell_budget, bake or reuse) and input shapes, each captured at its first
use and sharing one memory pool.

A replay reads and writes fixed addresses, so ``FrameGraphs`` keeps:

  * static input buffers for ``ray_basis``, ``betas``, ``body_pose``,
    ``global_orient``, ``transl``, ``bg_color`` and the grid, into which
    ``run`` copies each frame's values (stream-ordered, no host sync);
  * the state's tensors (field parameters, canonical bake,
    normalization): their addresses, the parameters' versions, the
    field's head hook and the model's frame knobs are the graphs'
    signature; a change drops the graphs, and the next frame captures
    anew;
  * the session's warp-cache tables (``RenderSession.tables``), which a
    bake graph writes and a reuse graph reads: graphs are kept per table
    address, for the last ``TABLE_SETS`` sessions;
  * the outputs (rgb, depth, alpha, counter and the counts) in the pool,
    cloned after each replay, before the next can overwrite them.

Before each capture the frame runs once eagerly on the capture stream.
The fused head's counters count at capture, when nothing runs: the
launches and rows captured into each graph are added on each replay.
"""
from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass

import torch

from ..kernels.fused_head import fused_field_head
from ..render.density_grid import DensityGridState
from .model import TrainState, _BakePlan

__all__ = ["FrameGraphs", "TABLE_SETS"]

INPUTS = ("ray_basis", "betas", "body_pose", "global_orient", "transl",
          "bg_color")
# the model's knobs that the flat frame's program reads
KNOBS = ("grid_size", "cache_n_cand", "term_T", "alpha_skip",
         "shared_corner_eval", "flat_tile_rows", "prepass_steps",
         "prepass_block")
TABLE_SETS = 4


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    out: dict                  # rgb, depth, alpha, counter in the pool
    counts: torch.Tensor       # (3,) int64 in the pool
    launches: int              # fused-head launches and rows per replay
    rows: int


def _layout(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype)



class FrameGraphs:
    """One model's captured flat frames (see the module docstring).
    ``captures`` counts the graphs captured, ``capture_seconds`` the host
    time they took (warm-ups included), ``replays`` the frames run."""

    def __init__(self, model):
        # the model owns this object: a weak reference back, so that the
        # model and its graphs' memory go when the model's last user does
        # (a reference cycle would keep them until a full gc pass)
        self._model = weakref.ref(model)
        self.device = model.device
        self.stream = torch.cuda.Stream(self.device)
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self._reset(None)

    @property
    def model(self):
        return self._model()

    def _reset(self, signature) -> None:
        self.signature = signature
        self.graphs: dict[tuple, _Graph] = {}
        self.table_sets: OrderedDict = OrderedDict()
        self.pool = torch.cuda.graph_pool_handle()
        self.inputs: dict[tuple, torch.Tensor] = {}

    def _signature(self, state: TrainState) -> tuple:
        field = self.model.field
        params = list(field.parameters())
        tensors = params + [state.center, state.scale]
        tensors += [t for t in state.deformer_cano if torch.is_tensor(t)]
        return (tuple(_layout(t) for t in tensors),
                tuple(p._version for p in params),
                id(getattr(field, "head_fn", None)),
                tuple(getattr(self.model, k) for k in KNOBS))

    def _stage(self, batch: dict, grid: DensityGridState
               ) -> tuple[dict, DensityGridState, tuple]:
        """Copy the frame's inputs into the static buffers (made at the
        first input of each name and shape); returns the buffers as a
        batch and a grid, and their layout."""
        vals = {k: batch[k] for k in INPUTS if batch.get(k) is not None}
        vals.update(zip(("density_cached", "occupancy", "aabb"), grid))
        staged = {}
        for k, v in vals.items():
            v = torch.as_tensor(v)
            dtype = torch.float32 if v.is_floating_point() else v.dtype
            key = (k, tuple(v.shape), dtype)
            if key not in self.inputs:
                self.inputs[key] = torch.empty(v.shape, dtype=dtype,
                                               device=self.device)
            staged[k] = self.inputs[key]
            staged[k].copy_(v, non_blocking=True)
        sgrid = DensityGridState(*(staged.pop(k) for k in (
            "density_cached", "occupancy", "aabb")))
        layout = tuple((k, tuple(v.shape)) for k, v in staged.items())
        return staged, sgrid, layout

    def _table_set(self, tables: tuple) -> tuple:
        """The tables' key; a new one beyond TABLE_SETS drops the graphs
        of the least recently used table set."""
        tkey = tuple(_layout(t) for t in tables)
        self.table_sets[tkey] = None
        self.table_sets.move_to_end(tkey)
        while len(self.table_sets) > TABLE_SETS:
            old, _ = self.table_sets.popitem(last=False)
            self.graphs = {k: g for k, g in self.graphs.items()
                           if k[-2] != old}
        return tkey

    def _capture(self, key: tuple, args: tuple) -> _Graph:
        model = self.model
        t0 = time.perf_counter()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            model._flat_frame(*args)   # warm-up: the frame's kernels once
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        launches, rows = fused_field_head.launches, fused_field_head.rows
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out, counts = model._flat_frame(*args)
        captured = _Graph(graph, out, counts,
                          fused_field_head.launches - launches,
                          fused_field_head.rows - rows)
        # the capture launched nothing: the replays count
        fused_field_head.launches, fused_field_head.rows = launches, rows
        self.graphs[key] = captured
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return captured

    def run(self, state: TrainState, batch: dict, grid: DensityGridState,
            image_shape: tuple[int, int], plan: _BakePlan, samp_budget: int,
            cell_budget: int) -> tuple[dict, torch.Tensor]:
        """One flat frame as one graph replay; returns copies of its rgb,
        depth, alpha and counter and of its counts (kept samples,
        occupied cells, evaluated samples)."""
        sig = self._signature(state)
        if sig != self.signature:
            self._reset(sig)
        sbatch, sgrid, layout = self._stage(batch, grid)
        key = (tuple(image_shape), samp_budget,
               cell_budget if plan.bake else None, plan.bake,
               self._table_set(plan.tables), layout)
        args = (state, sbatch, sgrid, tuple(image_shape), plan, samp_budget,
                cell_budget)
        g = self.graphs.get(key) or self._capture(key, args)
        g.graph.replay()
        self.replays += 1
        fused_field_head.launches += g.launches
        fused_field_head.rows += g.rows
        return ({k: v.clone() for k, v in g.out.items()}, g.counts.clone())
