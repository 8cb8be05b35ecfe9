"""The per-pose grid builds as captured CUDA graphs: JAX's jitted
``build_pose_grid`` and ``build_test_grid``
(``instantavatar_tpu/train/model.py:759``, ``:774``) on the card.

A frame rendered without a given grid builds its pose's own grid
(``AvatarModel._frame_grid``): the shell of the posed body
(``build_pose_grid``: the frame bake, ``nearest_vertex`` of every cell
against the posed vertices) or the max density of 5 jittered full-search
passes through the fused head (``build_test_grid``). Here each build is
one replay of a CUDA graph of ``AvatarModel._pose_grid`` or
``_test_grid``, one per grid kind and input shapes, captured at its first
use; the graphs share one memory pool.

A replay reads and writes fixed addresses, so ``GridGraphs`` keeps:

  * static input buffers for ``betas``, ``body_pose``, ``global_orient``,
    ``transl`` and ``idx``, into which ``run`` copies each pose
    (stream-ordered, no host sync), and, for the test grid, one for its
    (5, G, G, G, 3) jitter, which holds the default draw (a generator
    seeded 0) unless the caller passes one;
  * the state's tensors (the canonical bake; for the test grid also the
    field parameters and the input normalization; with SMPL parameters in
    the state, their leaves): their addresses, the field's head hook and
    the knobs the build reads are each graph's signature; a change
    captures that kind anew. A replay reads the parameters at their
    addresses, as JAX's jitted build takes them as arguments, so an
    optimizer's in-place update needs no new capture;
  * the grid the graph leaves, in the pool. ``run`` returns clones, so
    the grid is the caller's: the next pose's replay cannot overwrite a
    grid that a queued frame, a ``RenderSession`` or a caller still reads.

Before each capture the build runs once eagerly on the capture stream.
The fused head's counters count at capture, when nothing runs: the
launches and rows captured into each graph are added on each replay.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass

import torch

from ..kernels.fused_head import fused_field_head
from ..render.density_grid import DensityGridState
from .model import TrainState

__all__ = ["GridGraphs"]

INPUTS = ("betas", "body_pose", "global_orient", "transl", "idx")
# the model's knobs that each kind of build reads
KNOBS = {"smpl_shell": ("grid_size", "shell_margin"),
         "density": ("grid_size",)}


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    out: DensityGridState      # the grid, in the pool
    signature: tuple
    launches: int              # fused-head launches and rows per replay
    rows: int


def _layout(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype)


class GridGraphs:
    """One model's captured grid builds (see the module docstring).
    ``captures`` counts the graphs captured, ``capture_seconds`` the host
    time they took (warm-ups included), ``replays`` the grids built."""

    def __init__(self, model):
        # the model owns this object: a weak reference back (see
        # ``frame_graph.FrameGraphs``)
        self._model = weakref.ref(model)
        self.device = model.device
        self.stream = torch.cuda.Stream(self.device)
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self.graphs: dict[tuple, _Graph] = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.inputs: dict[tuple, torch.Tensor] = {}
        self.jitter: torch.Tensor | None = None
        self.default_jitter = False   # whether ``jitter`` holds it

    @property
    def model(self):
        return self._model()

    def _signature(self, kind: str, state: TrainState) -> tuple:
        model = self.model
        tensors = [t for t in state.deformer_cano if torch.is_tensor(t)]
        tensors += list(state.smpl or ())
        head = None
        if kind == "density":
            tensors += list(model.field.parameters())
            tensors += [state.center, state.scale]
            head = id(getattr(model.field, "head_fn", None))
        return (tuple(_layout(t) for t in tensors), head,
                tuple(getattr(model, k) for k in KNOBS[kind]))

    def _stage(self, batch: dict) -> tuple[dict, tuple]:
        """Copy the pose into the static buffers (made at the first input
        of each name and shape); returns them as a batch, and their
        layout."""
        staged = {}
        for k in INPUTS:
            if batch.get(k) is None:
                continue
            v = torch.as_tensor(batch[k])
            dtype = torch.float32 if v.is_floating_point() else v.dtype
            key = (k, tuple(v.shape), dtype)
            if key not in self.inputs:
                self.inputs[key] = torch.empty(v.shape, dtype=dtype,
                                               device=self.device)
            staged[k] = self.inputs[key]
            staged[k].copy_(v, non_blocking=True)
        return staged, tuple((k, tuple(v.shape), v.dtype)
                             for k, v in staged.items())

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

    def _capture(self, kind: str, args: tuple, signature: tuple) -> _Graph:
        model = self.model
        build = model._test_grid if kind == "density" else model._pose_grid
        t0 = time.perf_counter()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            build(*args)   # warm-up: the build's kernels once
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        launches, rows = fused_field_head.launches, fused_field_head.rows
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = build(*args)
        captured = _Graph(graph, out, signature,
                          fused_field_head.launches - launches,
                          fused_field_head.rows - rows)
        # the capture launched nothing: the replays count
        fused_field_head.launches, fused_field_head.rows = launches, rows
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return captured

    def run(self, kind: str, state: TrainState, batch: dict,
            jitter: torch.Tensor | None = None) -> DensityGridState:
        """One grid build of ``kind`` ("smpl_shell": ``build_pose_grid``,
        "density": ``build_test_grid``) as one graph replay; returns
        copies of the grid's tensors."""
        staged, layout = self._stage(batch)
        args = (state, staged)
        if kind == "density":
            args += (self._stage_jitter(jitter),)
        sig = self._signature(kind, state)
        key = (kind, layout)
        g = self.graphs.get(key)
        if g is None or g.signature != sig:
            self.graphs.pop(key, None)   # its memory back to the pool
            g = self.graphs[key] = self._capture(kind, args, sig)
        g.graph.replay()
        self.replays += 1
        fused_field_head.launches += g.launches
        fused_field_head.rows += g.rows
        return DensityGridState(*(t.clone() for t in g.out))
