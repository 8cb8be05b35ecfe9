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
    Adam then keeps the parameters bit-identical on every rank.
  * **Subject parallelism** (``stack_subjects``,
    ``make_multi_subject_step``): independent avatars, one (AvatarModel,
    TrainState) pair each, with no collective across subjects; a rank
    that holds several subjects steps them in turn.
  * **Sharded inference**: ``make_dp_render`` (the eval render of ray
    batches) and ``DPFrameRenderer`` (the flat frame render, one band of
    the image per rank through ``render_stream`` and the fused head), the
    outputs all-gathered in ray order.

A mesh made without an initialized process group is a world of 1: one
process holds every subject and ray shard. The renderers then render
every shard or band in turn, and ``DPFrameRenderer.render_band`` renders
any one band alone; a training step over several ray shards needs the
process group. JAX's per-program compile cache, its compiler
size-hopping, its static sample budgets with the overflow re-render and
its f16/u8 frame packing have no counterpart: the port's selection is
exact-count (see ``train/model.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

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
    by the ray count: the gradients (written back into ``.grad``), the
    losses and, with a grid update, ``density_cached`` and the occupancy
    vote (mean > 0.5). Returns (losses, grid)."""
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
    for p in params:
        p.grad = next(pieces).view_as(p).to(p.dtype)
    losses = dict(zip(keys, next(pieces).unbind()))
    if with_grid_update:
        grid = grid._replace(
            density_cached=next(pieces).view_as(grid.density_cached),
            occupancy=next(pieces).view_as(grid.density_cached) > 0.5)
    return losses, grid


def make_dp_train_step(avatar: AvatarModel, mesh: Mesh,
                       with_grid_update: bool = False):
    """Ray-data-parallel training step over the mesh's ray axis:
    ``step(state, batch, draws) -> (state, losses)`` with ``batch`` the
    step's whole ray batch (this rank renders ``shard_batch(batch,
    mesh)``) and ``draws`` this rank's (``rank_draws``). Gradients, losses
    and the grid update are averaged over the ray group in one
    ``all_reduce`` (with a group of one rank too: the identity), then the
    replicated optimizer applies them; in a world of 1 the step is the
    single-device step. After it, each parameter's ``.grad`` holds the
    averaged gradient."""
    if mesh.n_ray > 1 and mesh.group is None:
        raise ValueError("a step over several ray shards needs a process "
                         "group (torch.distributed) of their ranks")

    def step(state: TrainState, batch, draws: StepDraws):
        losses, new_grid = avatar.grads_and_losses(
            state, shard_batch(batch, mesh), draws, with_grid_update)
        if mesh.group is not None:
            losses, new_grid = _mean_over_rays(
                mesh, state.opt_state.params, losses, new_grid,
                with_grid_update)
        return avatar.apply_grads(state, new_grid), losses

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


def make_dp_render(avatar: AvatarModel, mesh: Mesh):
    """Ray-sharded inference: ``render(state, batch, grid) -> dict``, the
    eval render (``AvatarModel.render(eval_mode=True)``: the full search,
    the eval head, midpoint samples, no noise) of this rank's ray shard of
    ``batch`` (``rays_o``/``rays_d``, any leading shape), the rgb, depth,
    alpha and counter all-gathered in ray order into the batch's shape."""
    def render(state: TrainState, batch, grid) -> dict:
        parts = [_pack(avatar.render(state, shard_batch(batch, mesh, c),
                                     grid=grid, eval_mode=True))
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


class DPFrameRenderer:
    """The flat frame render split over the mesh's ray axis: each rank
    renders one band of the image through ``render_stream`` (the warp
    cache, the prepass on its block lattice, the flat selection, the
    fused head) and ``composite_frame``; the bands are all-gathered and
    put back in image order.

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
        if avatar.eval_sampling != "flat" or not avatar._use_cache():
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

    def _band(self, state: TrainState, frame: _Frame, band: int, grid,
              session: RenderSession | None) -> dict:
        sl = slice(band * frame.n_loc, (band + 1) * frame.n_loc)
        bb = {**frame.common, "ray_basis": frame.bases[band],
              **{k: v[sl] for k, v in frame.per_pixel.items()}}
        stream = self.avatar.render_stream(state, bb, grid, frame.band_shape,
                                           session)
        out = self.avatar.composite_frame(stream, bb.get("bg_color"))
        out["baked"] = stream.baked
        return out

    def _grid(self, state, batch, grid, session):
        return (self.avatar._frame_grid(state, batch, session)
                if grid is None else grid)

    def render_band(self, state: TrainState, batch, band: int, grid=None,
                    image_shape: tuple[int, int] | None = None,
                    session: RenderSession | None = None) -> dict:
        """Band ``band``'s program alone, in any process (no collective):
        the ``render_frame``-style dict of its H / n_ray x W pixels in band
        order, plus ``baked`` (whether it ran the warp-cache bake)."""
        with torch.no_grad():
            batch = self.avatar._resolve_batch(state, batch)
        grid = self._grid(state, batch, grid, session)
        return self._band(state, self._shape_frame(batch, image_shape),
                          band, grid, session)

    # -- launch / wait -----------------------------------------------------

    def render_frame_async(self, state: TrainState, batch, grid=None,
                           image_shape: tuple[int, int] | None = None,
                           session: RenderSession | None = None,
                           payload: str | None = None) -> dict:
        """Render this rank's band (in a world of 1, every band in turn)
        and launch the gather (``async_op=True``); returns the in-flight
        record for ``finish_frame``. ``payload`` sized the JAX render's
        frame buffer and is accepted for its signature only."""
        session = session if session is not None else RenderSession()
        with torch.no_grad():
            batch = self.avatar._resolve_batch(state, batch)
        grid = self._grid(state, batch, grid, session)
        frame = self._shape_frame(batch, image_shape)
        parts = []
        for c in _local_shards(self.mesh):
            out = self._band(state, frame, c, grid, session)
            # one more row: the band's sample count (exact in fp32 as two
            # 20-bit halves), its occupied cells and whether it baked
            extra = torch.tensor([[*divmod(out["n_samples"], 1 << 20),
                                   *divmod(out["n_occ"], 1 << 20),
                                   float(out["baked"]), 0.0]],
                                 device=out["rgb"].device)
            parts.append(torch.cat([_pack(out), extra]))
        full, work = _gather(torch.cat(parts), self.mesh, async_op=True)
        return {"buf": full, "work": work, "frame": frame,
                "session": session}

    def finish_frame(self, rec: dict) -> dict:
        """Wait for an in-flight frame's gather and return it in image
        order: rgb (n, 3), depth, alpha, counter (n,) on the device, the
        frame's kept samples, occupied cells, and the bands that baked."""
        if rec["work"] is not None:
            rec["work"].wait()
        frame = rec["frame"]
        rows = rec["buf"].reshape(self.n_ray, frame.n_loc + 1, 6)
        pix, extra = rows[:, :-1].reshape(frame.n, 6), rows[:, -1].double()
        if frame.perm is not None:
            img = torch.empty_like(pix)
            img[torch.as_tensor(frame.perm, device=pix.device)] = pix
            pix = img
        return {"rgb": pix[:, :3], "depth": pix[:, 3], "alpha": pix[:, 4],
                "counter": pix[:, 5],
                "n_samples": int((extra[:, 0] * (1 << 20)
                                  + extra[:, 1]).sum()),
                "n_occ": int((extra[:, 2] * (1 << 20) + extra[:, 3]).max()),
                "bands_baked": int(extra[:, 4].sum())}

    def render_frame(self, state: TrainState, batch, grid=None,
                     image_shape: tuple[int, int] | None = None,
                     session: RenderSession | None = None,
                     payload: str | None = None) -> dict:
        return self.finish_frame(self.render_frame_async(
            state, batch, grid=grid, image_shape=image_shape,
            session=session))

    def render_frames(self, state: TrainState, batches, grid=None,
                      image_shape: tuple[int, int] | None = None,
                      depth: int = 2, session: RenderSession | None = None):
        """Frame sequence with up to ``depth`` gathers in flight behind the
        next frame's band; one ``RenderSession`` spans the sequence (a
        turntable bakes once per pose)."""
        session = session if session is not None else RenderSession()
        inflight = []
        for batch in batches:
            inflight.append(self.render_frame_async(
                state, batch, grid=grid, image_shape=image_shape,
                session=session))
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


def make_multi_subject_step(mesh: Mesh, with_grid_update: bool = False):
    """Combined (subject x ray) training step: ``step(subjects, batches,
    draws) -> (subjects, losses)`` over this rank's subjects (a list of
    (AvatarModel, TrainState) pairs, ``Mesh.local_subjects``), each
    subject's whole ray batch and this rank's draws for it, stepped in
    turn by ``make_dp_train_step`` over the subject's ray group; no
    collective crosses subjects. With one ray shard each subject's step
    is the single-device step, its draws those of ``rank_draws`` (JAX's
    single-chip key semantics)."""
    def step(subjects, batches, draws):
        out, losses = [], []
        for (avatar, state), batch, d in zip(subjects, batches, draws,
                                             strict=True):
            state, l = make_dp_train_step(avatar, mesh, with_grid_update)(
                state, batch, d)
            out.append((avatar, state))
            losses.append(l)
        return out, losses
    return step
