"""The eval frames as captured CUDA graphs: JAX's one-program frame
(``_render_frame_fused``) and its jitted ray-sharded render
(``make_dp_render``) on the card.

JAX jits the whole frame into one program with static shapes, its sample,
ray and cell budgets learned per ``RenderSession``
(``instantavatar_tpu/train/model.py:835``, ``:1523``), in every eval
mode. Here each budgeted frame is one replay of a CUDA graph of one of
the model's frame programs:

  * ``AvatarModel._flat_frame``: the frame bake, the warp-cache bake at
    the cell budget (or none, when the frame reuses the session's
    tables), the prepass, the flat selection at the sample budget, the
    field eval through the fused head and the composite;
  * ``AvatarModel._rays_frame`` (the windows, dense, probed-dense and
    uncached modes): the bake or none, the prepass, the first
    ``ray_budget`` hit rays (JAX's ``jnp.nonzero(size=ray_budget)``)
    marched in static chunks, the padding written to a spare row;
  * ``AvatarModel._eval_render``: ``render(eval_mode=True)`` of a ray
    batch, one ray shard of ``parallel.make_dp_render`` (the full search
    per sample and the fused head; the gather stays outside).

The host knows each frame's program, image shape, budgets and whether it
bakes, so it picks the graph: one per (program, image shape, budgets,
bake or reuse, table set, input shapes), each captured at its first use
and sharing one memory pool.

A replay reads and writes fixed addresses, so ``FrameGraphs`` keeps:

  * static input buffers for the inputs each program reads
    (``INPUTS``: the ray basis or the per-ray ``rays_o``/``rays_d``, the
    pose, ``bg_color``, one colour or per ray) and the grid, into which
    ``run`` copies each frame's values (stream-ordered, no host sync);
  * the state's tensors (field parameters, canonical bake,
    normalization): their addresses and shapes, the field's head hook and
    the model's frame knobs are the graphs' signature; a change drops the
    graphs, and the next frame captures anew. A replay reads the
    parameters at their addresses, as JAX's jitted frame takes them as
    arguments, so an optimizer's in-place step needs no new capture (the
    head's bf16 weights are cast inside the graph);
  * the session's warp-cache tables (``RenderSession.tables``), which a
    bake graph writes and a reuse graph reads: graphs are kept per table
    address, for the last ``TABLE_SETS`` sessions;
  * the outputs (rgb, depth, alpha, counter and the counts) in the pool,
    cloned after each replay, before the next can overwrite them.

Before each capture the program runs once eagerly on the capture stream.
The fused head's counters count at capture, when nothing runs: the
launches and rows captured into each graph are added on each replay.
"""
from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..kernels.fused_head import fused_field_head
from ..render.density_grid import DensityGridState
from .model import TrainState

__all__ = ["FrameGraphs", "TABLE_SETS"]

_POSE = ("betas", "body_pose", "global_orient", "transl")
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


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    out: dict                  # rgb, depth, alpha, counter in the pool
    counts: torch.Tensor | None  # (3,) int64 in the pool (frames)
    launches: int              # fused-head launches and rows per replay
    rows: int


def _layout(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype)


class FrameGraphs:
    """One model's captured frame programs (see the module docstring).
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
        self.graphs: dict[_Key, _Graph] = {}
        self.table_sets: OrderedDict = OrderedDict()
        self.pool = torch.cuda.graph_pool_handle()
        self.inputs: dict[tuple, torch.Tensor] = {}

    def _signature(self, state: TrainState) -> tuple:
        field = self.model.field
        params = list(field.parameters())
        tensors = params + [state.center, state.scale]
        tensors += [t for t in state.deformer_cano if torch.is_tensor(t)]
        return (tuple(_layout(t) for t in tensors),
                id(getattr(field, "head_fn", None)),
                tuple(getattr(self.model, k) for k in KNOBS))

    def _stage(self, names: tuple, batch: dict,
               grid: DensityGridState | None
               ) -> tuple[dict, DensityGridState | None, tuple]:
        """Copy the frame's inputs ``names`` and its grid into the static
        buffers (made at the first input of each name and shape); returns
        the buffers as a batch and a grid, and their layout."""
        vals = {k: batch[k] for k in names if batch.get(k) is not None}
        if grid is not None:
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
        layout = tuple((k, tuple(v.shape)) for k, v in staged.items())
        sgrid = (None if grid is None else DensityGridState(*(
            staged.pop(k) for k in ("density_cached", "occupancy", "aabb"))))
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
                           if k.tables != old}
        return tkey

    def _capture(self, key: _Key, args: tuple) -> _Graph:
        program = getattr(self.model, key.program)
        t0 = time.perf_counter()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            program(*args)   # warm-up: the program's kernels once
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        launches, rows = fused_field_head.launches, fused_field_head.rows
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out, counts = program(*args)
        captured = _Graph(graph, out, counts,
                          fused_field_head.launches - launches,
                          fused_field_head.rows - rows)
        # the capture launched nothing: the replays count
        fused_field_head.launches, fused_field_head.rows = launches, rows
        self.graphs[key] = captured
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return captured

    def run(self, program: str, state: TrainState, batch: dict,
            grid: DensityGridState | None, *args
            ) -> tuple[dict, torch.Tensor | None]:
        """One call of the model's frame program ``program`` as one graph
        replay, with the program's arguments: ``_flat_frame`` (image
        shape, bake plan, sample and cell budgets), ``_rays_frame`` (image
        shape or None, bake plan or None, chunk, ray and cell budgets) or
        ``_eval_render`` (none). Returns copies of its outputs (rgb,
        depth, alpha, counter) and of its counts (None for
        ``_eval_render``)."""
        sig = self._signature(state)
        if sig != self.signature:
            self._reset(sig)
        sbatch, sgrid, layout = self._stage(INPUTS[program], batch, grid)
        image_shape, plan, *budgets = args or (None, None)
        bake = None if plan is None else plan.bake
        if budgets and not bake:
            budgets[-1] = None   # the cell budget of a bake it does not run
        key = _Key(program, image_shape and tuple(image_shape),
                   tuple(budgets), bake,
                   None if plan is None else self._table_set(plan.tables),
                   layout)
        g = self.graphs.get(key) or self._capture(
            key, (state, sbatch, sgrid, *args))
        g.graph.replay()
        self.replays += 1
        fused_field_head.launches += g.launches
        fused_field_head.rows += g.rows
        return ({k: v.clone() for k, v in g.out.items()},
                None if g.counts is None else g.counts.clone())
