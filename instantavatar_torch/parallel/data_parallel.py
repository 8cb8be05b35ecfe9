"""Multi-device parallelism over ``torch.distributed``.

Port of ``instantavatar_tpu/parallel/data_parallel.py``. JAX lays its
devices out on a (subject, ray) ``Mesh`` and runs each step as one
``shard_map`` program; here each position of that layout is a rank (a
process with its own device), and the collectives are explicit:

  * **Ray data-parallelism** (``make_dp_train_step``): every ray rank of
    a subject takes its contiguous slice of the step's ray batch
    (``shard_batch``, JAX's ``P("ray")``) and its own draws
    (``rank_draws``), runs ``AvatarModel.grads_and_losses``, and one
    ``all_reduce`` over the subject's ray group averages one flat bucket:
    every gradient (field, and the SMPL leaves with ``optimize_smpl``), the
    loss components and, with a grid update, the density sweep and the
    occupancy vote (JAX's single ``pmean`` over the tree). The replicated
    Adam then keeps the parameters bit-identical on every rank. On CUDA
    models with an NCCL group (or none) the step is one replay of a
    captured CUDA graph, the ``all_reduce`` inside it; a gloo group runs
    eagerly.
  * **Subject parallelism** (``stack_subjects``,
    ``make_multi_subject_step``): independent avatars, one (AvatarModel,
    TrainState) pair each, with no collective across subjects; a rank
    that holds several subjects steps them in turn (on graphs: one replay
    per subject, queued back to back).
  * **Sharded inference**: ``make_dp_render`` (the eval render of ray
    batches) and ``DPFrameRenderer`` (the flat frame render, one band of
    the image per rank through ``render_stream`` and the fused head), the
    outputs all-gathered in ray order. On a CUDA model each local shard
    or band is one replay of a captured CUDA graph
    (``train/graphs.py``), the gather outside it, so gloo and NCCL
    groups both replay.

A mesh made without an initialized process group is a world of 1: one
process holds every subject and ray shard. The renderers then render
every shard or band in turn, and ``DPFrameRenderer.render_band`` renders
any one band alone; a training step over several ray shards needs the
process group. The frame render keeps JAX's static sample and cell
budgets and its overflow re-render (``DPFrameRenderer``); JAX's
per-program compile cache, its compiler size-hopping and its f16/u8 frame
packing have no counterpart.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..train.graphs import StepGraphs
from ..train.model import AvatarModel, RenderSession, StepDraws, TrainState

__all__ = ["PER_FRAME", "Mesh", "make_mesh", "shard_batch", "rank_draws",
           "make_dp_train_step", "make_dp_render", "DPFrameRenderer",
           "dp_render_frame", "stack_subjects", "make_multi_subject_step"]

# the per-frame leaves of a batch: replicated on every ray rank
PER_FRAME = frozenset({"betas", "body_pose", "global_orient", "transl",
                       "idx"})


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (subject, ray) layout of the ranks: rank
    ``subject * n_ray + ray``. ``group`` is the process group of its
    subject's ray ranks, None in a world of 1."""
    n_subject: int
    n_ray: int
    subject: int
    ray: int
    group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {"subject": self.n_subject, "ray": self.n_ray}

    def local_subjects(self, n: int) -> list[int]:
        """The subjects of ``n`` this rank holds: all of them in a world of
        1, else its contiguous block of ``n`` over the subject axis (JAX's
        ``P("subject")``)."""
        if self.group is None:
            return list(range(n))
        return [int(k) for k in np.array_split(np.arange(n),
                                               self.n_subject)[self.subject]]


def make_mesh(n_ray: int | None = None, n_subject: int = 1) -> Mesh:
    """The (subject, ray) layout of the initialized process group's ranks,
    ``n_ray`` defaulting to world // n_subject; every rank must call it,
    in the same order (it makes one group per subject). Without a process
    group: a world of 1 with that layout's shape (``n_ray`` default 1)."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(n_subject, n_ray or 1, 0, 0, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_ray is None:
        n_ray = world // n_subject
    if n_subject * n_ray != world:
        raise ValueError(f"a {n_subject} x {n_ray} mesh needs "
                         f"{n_subject * n_ray} ranks, the group has {world}")
    group = None
    for s in range(n_subject):
        g = dist.new_group(list(range(s * n_ray, (s + 1) * n_ray)))
        if rank // n_ray == s:
            group = g
    return Mesh(n_subject, n_ray, rank // n_ray, rank % n_ray, group)


def shard_batch(batch: dict[str, Any], mesh: Mesh,
                ray: int | None = None) -> dict[str, Any]:
    """Ray shard ``ray`` (default this rank's) of a batch: the contiguous
    slice of the leading axis of each per-ray leaf (numpy array or
    tensor); the per-frame leaves (``PER_FRAME``) and scalars whole."""
    ray = mesh.ray if ray is None else ray
    out = {}
    for k, v in batch.items():
        if k in PER_FRAME or np.ndim(v) == 0:
            out[k] = v
            continue
        n = v.shape[0]
        if n % mesh.n_ray:
            raise ValueError(f"{k}: {n} rows do not split over "
                             f"{mesh.n_ray} ray shards")
        m = n // mesh.n_ray
        out[k] = v[ray * m:(ray + 1) * m]
    return out


def _ray_seed(seed: int, ray: int) -> int:
    return int(np.random.SeedSequence([seed, ray]).generate_state(1)[0])


def rank_draws(avatar: AvatarModel, mesh: Mesh, seed: int, n_rays: int,
               with_grid_update: bool, *, ray: int | None = None
               ) -> StepDraws:
    """Ray shard ``ray``'s (default this rank's) draws for one step, on the
    model's device. With one ray shard, the single-device draws of a
    generator seeded ``seed`` (``AvatarModel.draw``). With several, as JAX
    folds the shard index into the step key for the render and keeps the
    un-folded key for the grid: the jitter and noise of its ``n_rays`` rays
    from a generator seeded by (``seed``, ``ray``), and the grid jitter
    from one seeded ``seed`` alone, the same on every rank."""
    dev = avatar.device
    if mesh.n_ray == 1:
        return avatar.draw(torch.Generator(device=dev).manual_seed(seed),
                           n_rays, with_grid_update)
    ray = mesh.ray if ray is None else ray
    own = avatar.draw(torch.Generator(device=dev).manual_seed(
        _ray_seed(seed, ray)), n_rays, False)
    if not with_grid_update:
        return own
    g = torch.Generator(device=dev).manual_seed(seed)
    return own._replace(grid_jitter=torch.rand(
        (avatar.grid_size,) * 3 + (3,), generator=g, device=dev))


def _mean_over_rays(mesh: Mesh, params: list[torch.Tensor], losses: dict,
                    grid, with_grid_update: bool):
    """One all_reduce over the ray group of one flat fp32 bucket, divided
    by the ray count: the gradients, the losses and, with a grid update,
    ``density_cached`` and the occupancy vote (mean > 0.5). The averages
    are written in place: into each parameter's ``.grad`` (made where it
    has none) and into ``grid``'s own tensors, so that a captured step
    finds them at the addresses it read. Returns (losses, grid)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    keys = sorted(losses)
    parts = [g.reshape(-1).float() for g in grads]
    parts.append(torch.stack([losses[k].float().reshape(()) for k in keys]))
    if with_grid_update:
        parts += [grid.density_cached.reshape(-1).float(),
                  grid.occupancy.reshape(-1).float()]
    bucket = torch.cat(parts)
    dist.all_reduce(bucket, group=mesh.group)
    bucket /= mesh.n_ray
    pieces = iter(bucket.split([x.numel() for x in parts]))
    with torch.no_grad():
        for p in params:
            mean = next(pieces).view_as(p)
            if p.grad is None:
                p.grad = mean.to(p.dtype)
            else:
                p.grad.copy_(mean)
        losses = dict(zip(keys, next(pieces).unbind()))
        if with_grid_update:
            grid.density_cached.copy_(
                next(pieces).view_as(grid.density_cached))
            grid.occupancy.copy_(
                next(pieces).view_as(grid.density_cached) > 0.5)
    return losses, grid


def _capturable(mesh: Mesh, graph: bool | None) -> bool:
    """Whether the mesh's ray group can sit inside a CUDA graph: none or
    NCCL. A gloo group runs its collectives through the host, so its
    steps run eagerly, and ``graph=True`` raises there."""
    ok = (mesh.group is None
          or "nccl" in str(dist.get_backend(mesh.group)))
    if graph and not ok:
        raise ValueError("a gloo ray group cannot be captured in a CUDA "
                         "graph: its DP steps run eagerly (graph=None or "
                         "False)")
    return ok


def _graphed(avatar: AvatarModel, mesh: Mesh, graph: bool | None) -> bool:
    """Whether ``avatar``'s DP step replays a captured CUDA graph: by
    default on a CUDA model whose ray group can be captured; never on the
    CPU, where ``graph=True`` raises."""
    ok = _capturable(mesh, graph)
    if graph is None:
        return avatar.device.type == "cuda" and ok
    return avatar._graphed(graph)


def _ray_reduce(mesh: Mesh):
    """The DP step's hook between autograd and the optimizer
    (``graphs.step_body``): (the ray group, ``_mean_over_rays`` on
    it); None in a world of 1."""
    if mesh.group is None:
        return None
    return mesh.group, functools.partial(_mean_over_rays, mesh)


def _dp_step(avatar: AvatarModel, mesh: Mesh, with_grid_update: bool,
             graph: bool, state: TrainState, batch, draws: StepDraws):
    """One DP step of ``make_dp_train_step``, on graphs or eagerly."""
    local = shard_batch(batch, mesh)
    reduce = _ray_reduce(mesh)
    if graph:
        if (draws.grid_jitter is not None) != with_grid_update:
            raise ValueError("the draws' grid jitter does not match "
                             f"with_grid_update={with_grid_update}")
        return avatar._graphs("step_graphs", StepGraphs).run(
            state, local, draws, update=with_grid_update, reduce=reduce)
    losses, grid = avatar.grads_and_losses(state, local, draws,
                                           with_grid_update)
    if reduce is not None:
        losses, grid = reduce[1](state.opt_state.params, losses, grid,
                                 with_grid_update)
    return avatar.apply_grads(state, grid), losses


def make_dp_train_step(avatar: AvatarModel, mesh: Mesh,
                       with_grid_update: bool = False, *,
                       graph: bool | None = None):
    """Ray-data-parallel training step over the mesh's ray axis:
    ``step(state, batch, draws) -> (state, losses)`` with ``batch`` the
    step's whole ray batch (this rank renders ``shard_batch(batch,
    mesh)``) and ``draws`` this rank's (``rank_draws``). Gradients, losses
    and the grid update are averaged over the ray group in one
    ``all_reduce`` (with a group of one rank too: the identity), then the
    replicated optimizer applies them; in a world of 1 the step is the
    single-device step. After it, each parameter's ``.grad`` holds the
    averaged gradient.

    On a CUDA model whose ray group is None or NCCL the step is one replay
    of a captured CUDA graph of the whole step, the ``all_reduce``
    included (JAX's jitted ``shard_map`` program; ``train/graphs.py``),
    with no host sync inside; the grid is written into ``state.grid``'s
    tensors, as the optimizer writes the parameters, and a failed capture
    raises. A gloo group cannot be captured: its steps run eagerly, as on
    the CPU and with ``graph=False``; ``graph=True`` raises there."""
    if mesh.n_ray > 1 and mesh.group is None:
        raise ValueError("a step over several ray shards needs a process "
                         "group (torch.distributed) of their ranks")
    graph = _graphed(avatar, mesh, graph)

    def step(state: TrainState, batch, draws: StepDraws):
        return _dp_step(avatar, mesh, with_grid_update, graph, state, batch,
                        draws)

    return step


def _local_shards(mesh: Mesh) -> list[int]:
    return [mesh.ray] if mesh.group is not None else list(range(mesh.n_ray))


def _gather(local: torch.Tensor, mesh: Mesh, async_op: bool = False):
    """(rows, C) of this rank -> (n_ray * rows, C) in ray order, through
    ``all_gather_into_tensor`` on the ray group; in a world of 1 ``local``
    already holds every shard. Returns (tensor, work or None)."""
    if mesh.group is None:
        return local, None
    out = local.new_empty((mesh.n_ray * local.shape[0],) + local.shape[1:])
    work = dist.all_gather_into_tensor(out, local.contiguous(),
                                       group=mesh.group, async_op=async_op)
    return out, work


_OUT_KEYS = ("rgb", "depth", "alpha", "counter")


def _pack(out: dict) -> torch.Tensor:
    """rgb, depth, alpha, counter -> (rows, 6) fp32."""
    return torch.cat([out["rgb"].reshape(-1, 3).float()]
                     + [out[k].reshape(-1, 1).float()
                        for k in _OUT_KEYS[1:]], dim=1)


def make_dp_render(avatar: AvatarModel, mesh: Mesh, *,
                   graph: bool | None = None):
    """Ray-sharded inference: ``render(state, batch, grid) -> dict``, the
    eval render (``AvatarModel.render(eval_mode=True)``: the full search,
    the eval head, midpoint samples, no noise) of this rank's ray shard of
    ``batch`` (``rays_o``/``rays_d``, any leading shape), the rgb, depth,
    alpha and counter all-gathered in ray order into the batch's shape.

    On a CUDA model each local shard's render is one replay of a captured
    CUDA graph (JAX jits the ``shard_map`` program; ``FrameGraphs`` keyed
    by the shard's shapes), its rays and pose staged into static buffers
    and its outputs cloned before the next replay; the gather runs outside
    the graph, on a gloo group too. ``graph=False`` renders eagerly;
    ``graph=True`` raises on a CPU model, and a failed capture raises."""
    graph = avatar._graphed(graph)

    def render(state: TrainState, batch, grid) -> dict:
        program = avatar._frame_program("_eval_render", graph)
        parts = [_pack(program(state, shard_batch(batch, mesh, c), grid)[0])
                 for c in _local_shards(mesh)]
        full, _ = _gather(torch.cat(parts), mesh)
        shape = tuple(np.shape(batch["rays_o"])[:-1])
        return {"rgb": full[:, :3].reshape(*shape, 3),
                "depth": full[:, 3].reshape(shape),
                "alpha": full[:, 4].reshape(shape),
                "counter": full[:, 5].reshape(shape)}
    return render


class _Frame(NamedTuple):
    """A frame split into bands: the batch without its basis and per-pixel
    leaves, each band's basis, the per-pixel leaves in band order, and the
    band layout."""
    common: dict
    bases: list          # (4 or 5, 3) per band
    per_pixel: dict      # leaf -> rows in band order (n, ...)
    n: int
    n_loc: int
    band_shape: tuple    # (H // n_ray, W)
    perm: np.ndarray | None


# the chunk of JAX's budgets (DPFrameRenderer's default)
CHUNK = 32768


def _halves(x: torch.Tensor) -> torch.Tensor:
    """A count as two 20-bit halves, exact in fp32."""
    return torch.stack([x // (1 << 20), x % (1 << 20)]).float()


class DPFrameRenderer:
    """The flat frame render split over the mesh's ray axis: each rank
    renders one band of the image (``AvatarModel._flat_frame``: the warp
    cache, the prepass on its block lattice, the flat selection, the
    fused head, the composite; one replay of a captured CUDA graph on a
    CUDA model) at the static budgets of JAX's sharded program; the bands
    are all-gathered, with each band's counts, and put back in image
    order.

    The budgets (JAX's ``_budgets``) are the session's for the band shape
    (``RenderSession.open``), the cell budget at most the model's
    ``cell_budget``; ``finish_frame`` learns them from the largest band's
    counts and re-renders every band when one overflowed
    (``RenderSession.settle``). Every rank takes the same decision, from
    the same gathered counts.

    ``layout="stride"`` (the default) deals p-row block-rows round-robin
    over the bands, p the prepass block of a band (3 or 2, else 1): band c
    takes block-rows c, c + n_ray, ..., through the 5-row basis
    [o, b0 + c*p*by, bx, by, n_ray*by], so each band sees a like share of
    the body; it falls back to contiguous bands when the block-rows do not
    split evenly. ``layout="band"`` takes contiguous bands of H / n_ray
    rows, each band's first row folded into b0. The image height must
    split into ``n_ray`` bands.

    Every rank bakes the whole warp cache (replicated work) and keeps it
    in its ``RenderSession`` across a turntable. The bands' streams are
    composited one band at a time, so a band's cumulative sums start at
    its own first sample: the frame agrees with the single-device frame to
    fp32 rounding, not bit for bit.
    """

    def __init__(self, avatar: AvatarModel, mesh: Mesh,
                 layout: str = "stride"):
        if layout not in ("stride", "band"):
            raise ValueError(f"unknown layout {layout!r}")
        if not avatar._flat():
            raise ValueError("DPFrameRenderer runs the flat warp-cache "
                             "render (eval_sampling='flat')")
        self.avatar = avatar
        self.mesh = mesh
        self.layout = layout
        self.n_ray = mesh.n_ray

    # -- per-frame shaping ------------------------------------------------

    def _shape_frame(self, batch, image_shape) -> _Frame:
        if image_shape is None:
            raise ValueError("DPFrameRenderer needs image_shape to split "
                             "bands")
        H, W = image_shape
        n, R = H * W, self.n_ray
        if H % R:
            raise ValueError(f"{H} rows do not split into {R} bands")
        H_loc = H // R
        p = self.avatar._block_size(H_loc, W)
        stride = self.layout == "stride" and (H // p) % R == 0
        perm = None
        if stride:
            perm = (np.arange(n).reshape(H // p // R, R, p * W)
                    .transpose(1, 0, 2).reshape(-1))
        b = torch.as_tensor(batch["ray_basis"], dtype=torch.float32,
                            device=self.avatar.device)
        if stride:
            bases = [torch.stack([b[0], b[1] + (c * p) * b[3], b[2], b[3],
                                  R * b[3]]) for c in range(R)]
        else:
            bases = [torch.stack([b[0], b[1] + (c * H_loc) * b[3], b[2],
                                  b[3]]) for c in range(R)]
        common, per_pixel = {}, {}
        for k, v in batch.items():
            if k in ("rgb", "alpha", "ray_basis"):
                continue
            if (k not in PER_FRAME and np.ndim(v) >= 1
                    and v.shape[0] == n):
                per_pixel[k] = v if perm is None else v[
                    perm if not torch.is_tensor(v)
                    else torch.as_tensor(perm, device=v.device)]
            else:
                common[k] = v
        return _Frame(common, bases, per_pixel, n, n // R, (H_loc, W), perm)

    def _start(self, state: TrainState, batch, grid, image_shape,
               session: RenderSession | None, graph: bool | None) -> dict:
        """A frame's record: its bands, grid, memo key and budgets (the
        session's for the band shape, else the priors)."""
        av = self.avatar
        session = session if session is not None else RenderSession()
        key, refs = av._frame_key(state, batch)
        with torch.no_grad():
            rbatch = av._resolve_batch(state, batch)
        if grid is None:
            grid = av._frame_grid(state, batch, session, key, refs, graph)
        frame = self._shape_frame(rbatch, image_shape)
        p = av._block_size(*frame.band_shape)
        skey = (frame.n_loc, (*frame.band_shape, p))
        rec = dict(state=state, frame=frame, grid=grid, session=session,
                   key=key, refs=refs, skey=skey, flat=True, n=frame.n_loc,
                   chunk=CHUNK, cell_cap=av.cell_budget,
                   graph=av._graphed(graph), bakes=0)
        session.open(rec, av, frame.n_loc // (p * p))
        return rec

    def _band(self, rec: dict, band: int, rebake: bool = False
              ) -> tuple[dict, torch.Tensor, Any]:
        """Band ``band``'s program at ``rec``'s budgets: (rgb, depth,
        alpha, counter; the counts; the bake plan)."""
        av, frame = self.avatar, rec["frame"]
        sl = slice(band * frame.n_loc, (band + 1) * frame.n_loc)
        bb = {**frame.common, "ray_basis": frame.bases[band],
              **{k: v[sl] for k, v in frame.per_pixel.items()}}
        plan = av._bake_plan(rec["session"], rec["key"], rec["refs"],
                             rec["grid"], rec["cell_budget"], rebake)
        out, counts = av._frame_program("_flat_frame", rec["graph"])(
            rec["state"], bb, rec["grid"], frame.band_shape, plan,
            rec["samp_budget"], rec["cell_budget"])
        av._commit_bake(rec["session"], plan)
        return out, counts, plan

    def render_band(self, state: TrainState, batch, band: int, grid=None,
                    image_shape: tuple[int, int] | None = None,
                    session: RenderSession | None = None,
                    graph: bool | None = None) -> dict:
        """Band ``band``'s program alone, in any process (no collective),
        re-rendered while a count overflows (``RenderSession.settle``; at
        most 4 renders in all): the ``render_frame``-style dict of its
        H / n_ray x W pixels in band order, plus ``baked`` (whether it ran
        the warp-cache bake)."""
        rec = self._start(state, batch, grid, image_shape, session, graph)
        rec["baked"] = False

        def render(rec, rebake=False):
            out, counts, plan = self._band(rec, band, rebake)
            rec.update(out=out, counts=counts, limit=plan.limit,
                       baked=rec["baked"] or plan.bake)
        render(rec)
        n_hit, n_occ, _ = rec["session"].settle(
            rec, render, lambda: rec["counts"].tolist(), passes=3)
        return {**rec["out"], "n_samples": n_hit, "n_occ": n_occ,
                "baked": rec["baked"]}

    # -- launch / wait -----------------------------------------------------

    def _dispatch(self, rec: dict, rebake: bool = False) -> None:
        """Render this rank's bands (in a world of 1, every band in turn)
        and launch the gather (``async_op=True``). Each band ships one
        more row: its kept samples and occupied cells (two 20-bit halves
        each), whether it baked and the cell budget of its tables."""
        parts = []
        for c in _local_shards(self.mesh):
            out, counts, plan = self._band(rec, c, rebake)
            dev = counts.device
            extra = torch.cat([
                _halves(counts[0]), _halves(counts[1]),
                torch.full((1,), float(plan.bake), device=dev),
                torch.full((1,), float(plan.limit), device=dev)])
            parts.append(torch.cat([_pack(out), extra[None]]))
        rec["buf"], rec["work"] = _gather(torch.cat(parts), self.mesh,
                                          async_op=True)

    def render_frame_async(self, state: TrainState, batch, grid=None,
                           image_shape: tuple[int, int] | None = None,
                           session: RenderSession | None = None,
                           payload: str | None = None,
                           graph: bool | None = None) -> dict:
        """Render this rank's band (in a world of 1, every band in turn)
        at the session's budgets and launch the gather; returns the
        in-flight record for ``finish_frame``. ``payload`` sized the JAX
        render's frame buffer and is accepted for its signature only."""
        rec = self._start(state, batch, grid, image_shape, session, graph)
        self._dispatch(rec)
        return rec

    def _counts(self, rec: dict) -> tuple[int, int, list]:
        """Wait for the gather; the band counts (one host read): the
        largest kept samples and occupied cells, and each band's
        (samples, cells, baked). Sets ``rec["limit"]``, the smallest
        table cell budget, and adds the bands that baked to
        ``rec["bakes"]``."""
        if rec["work"] is not None:
            rec["work"].wait()
        frame = rec["frame"]
        rows = rec["buf"].reshape(self.n_ray, frame.n_loc + 1, 6)
        extra = rows[:, -1].double().cpu().numpy()
        bands = [(int(e[0]) * (1 << 20) + int(e[1]),
                  int(e[2]) * (1 << 20) + int(e[3]), int(e[4]))
                 for e in extra]
        rec["limit"] = int(extra[:, 5].min())
        rec["bakes"] += sum(b[2] for b in bands)
        return max(b[0] for b in bands), max(b[1] for b in bands), bands

    def finish_frame(self, rec: dict) -> dict:
        """Wait for an in-flight frame's gather, learn the budgets, and
        re-render on an overflow (see the class docstring); return it in
        image order: rgb (n, 3), depth, alpha, counter (n,) on the device,
        the frame's kept samples, occupied cells, and the bands that ran
        the bake over the frame's renders."""
        _, n_occ, bands = rec["session"].settle(
            rec, self._dispatch, lambda: self._counts(rec))
        frame = rec["frame"]
        rows = rec["buf"].reshape(self.n_ray, frame.n_loc + 1, 6)
        pix = rows[:, :-1].reshape(frame.n, 6)
        if frame.perm is not None:
            img = torch.empty_like(pix)
            img[torch.as_tensor(frame.perm, device=pix.device)] = pix
            pix = img
        return {"rgb": pix[:, :3], "depth": pix[:, 3], "alpha": pix[:, 4],
                "counter": pix[:, 5],
                "n_samples": sum(b[0] for b in bands), "n_occ": n_occ,
                "bands_baked": rec["bakes"]}

    def render_frame(self, state: TrainState, batch, grid=None,
                     image_shape: tuple[int, int] | None = None,
                     session: RenderSession | None = None,
                     payload: str | None = None,
                     graph: bool | None = None) -> dict:
        return self.finish_frame(self.render_frame_async(
            state, batch, grid=grid, image_shape=image_shape,
            session=session, graph=graph))

    def render_frames(self, state: TrainState, batches, grid=None,
                      image_shape: tuple[int, int] | None = None,
                      depth: int = 2, session: RenderSession | None = None,
                      graph: bool | None = None):
        """Frame sequence with up to ``depth`` gathers in flight behind the
        next frame's band; one ``RenderSession`` spans the sequence (a
        turntable bakes once per pose)."""
        session = session if session is not None else RenderSession()
        inflight = []
        for batch in batches:
            inflight.append(self.render_frame_async(
                state, batch, grid=grid, image_shape=image_shape,
                session=session, graph=graph))
            if len(inflight) > depth:
                yield self.finish_frame(inflight.pop(0))
        while inflight:
            yield self.finish_frame(inflight.pop(0))


def dp_render_frame(avatar: AvatarModel, mesh: Mesh, state: TrainState,
                    batch: dict[str, Any], grid,
                    image_shape: tuple[int, int],
                    session: RenderSession | None = None,
                    layout: str = "stride") -> dict:
    """One frame through a one-off ``DPFrameRenderer``; hold a renderer
    and a session for sequences."""
    return DPFrameRenderer(avatar, mesh, layout=layout).render_frame(
        state, batch, grid=grid, image_shape=image_shape, session=session)


# -- subject parallelism ---------------------------------------------------


def stack_subjects(subjects) -> list[tuple[AvatarModel, TrainState]]:
    """The port's form of JAX's stacked states: a list of (AvatarModel,
    TrainState) pairs, one per subject, each model with its own field
    module (JAX stacks the parameters on a leading axis and vmaps one
    step; eager PyTorch has no vmap over the step's exact-count
    selection)."""
    return [(avatar, state) for avatar, state in subjects]


def make_multi_subject_step(mesh: Mesh, with_grid_update: bool = False,
                            *, graph: bool | None = None):
    """Combined (subject x ray) training step: ``step(subjects, batches,
    draws) -> (subjects, losses)`` over this rank's subjects (a list of
    (AvatarModel, TrainState) pairs, ``Mesh.local_subjects``), each
    subject's whole ray batch and this rank's draws for it, each subject
    stepped as ``make_dp_train_step`` steps it over the subject's ray
    group; no collective crosses subjects. With one ray shard each
    subject's step is the single-device step, its draws those of
    ``rank_draws`` (JAX's single-chip key semantics).

    JAX vmaps every subject's step into one program. Here, on CUDA
    models whose ray group is None or NCCL, each subject's step is one
    replay of its own model's captured graph: the S replays are queued
    back to back in one stream with no host read between them, so the
    combined step synchronises once, when its losses are read. A gloo
    group, the CPU and ``graph=False`` step the subjects eagerly in turn;
    ``graph=True`` raises on a gloo group (here) and on a CPU model (at
    its first step)."""
    _capturable(mesh, graph)   # graph=True on a gloo group raises

    def step(subjects, batches, draws):
        out, losses = [], []
        for (avatar, state), batch, d in zip(subjects, batches, draws,
                                             strict=True):
            state, l = _dp_step(avatar, mesh, with_grid_update,
                                _graphed(avatar, mesh, graph), state, batch,
                                d)
            out.append((avatar, state))
            losses.append(l)
        return out, losses
    return step
