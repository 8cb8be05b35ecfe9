"""Corner-packed bilinear / trilinear sampling.

Port of the packed samplers in ``instantavatar_tpu/ops/grid_sample.py``.
A packed row holds all corners of one cell (2-D: corner = dy*2+dx; 3-D:
corner = dz*4+dy*2+dx, edge-replicated at the far boundary), so a sample
costs one row gather plus the lerp. Coordinates keep the JAX layout: xyz
order, (C, D, H, W) voxels, align-corners, border clamping.

``lerp_dtype`` contract (as in JAX): the lerp weights and the output use
``lerp_dtype`` (default: the rows' dtype); the corner products are summed
in fp32 and the sum is rounded once to ``lerp_dtype``. To get that rounding
on every device, the operands are rounded to ``lerp_dtype`` and then
multiplied and summed in fp32 (a bf16 einsum would round differently).

The shared-corner samplers (``grid_sample_2d_packed_shared``,
``grid_sample_3d_packed_shared``) gather one row per reference point and
lerp Q variants of it against that row with unclamped weights (a variant
outside the reference cell extrapolates linearly): the products are
summed in fp32 (an fp32 contraction) and rounded once to ``lerp_dtype``.
``grid_sample_3d`` is the plain eight-gather trilinear sampler of a (C,
D, H, W) voxel.

Gradients flow to the table and to the coordinates. The table's gradient
is a scatter-add of the row gradients (``_GatherRows``): accumulated in
fp32 with ``index_add_`` and rounded once to the table's dtype. (The
default backward of ``table[idx]`` on CUDA sorts the indices and walks
each run of duplicates serially, in the table's dtype: measured ~160 ms
per call at the flagship training shapes on an H100, where most samples
hit the few thousand cells of the body.)
"""
from __future__ import annotations

import torch

__all__ = ["pack_corners_2d", "pack_corners_3d", "grid_sample_2d_packed",
           "grid_sample_3d_packed", "grid_sample_2d_packed_shared",
           "grid_sample_3d_packed_shared", "grid_sample_3d"]


def _edge_pad_after(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """Append one edge-replicated slice at the end of each dim in ``dims``."""
    for d in dims:
        x = torch.cat([x, x.narrow(d, x.shape[d] - 1, 1)], dim=d)
    return x


def pack_corners_2d(plane: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> (H*W, 4*C) corner-packed rows (corner = dy*2 + dx)."""
    C, H, W = plane.shape
    v = _edge_pad_after(plane, (1, 2))
    rows = [v[:, dy:dy + H, dx:dx + W] for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(rows, 0).permute(2, 3, 0, 1).reshape(H * W, 4 * C)


def pack_corners_3d(voxel: torch.Tensor) -> torch.Tensor:
    """(C, D, H, W) -> (D*H*W, 8*C) corner-packed rows
    (corner = dz*4 + dy*2 + dx)."""
    C, D, H, W = voxel.shape
    v = _edge_pad_after(voxel, (1, 2, 3))
    rows = [v[:, dz:dz + D, dy:dy + H, dx:dx + W]
            for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return torch.stack(rows, 0).permute(2, 3, 4, 0, 1) \
        .reshape(D * H * W, 8 * C)


class _GatherRows(torch.autograd.Function):
    """rows = table[idx] with an fp32 ``index_add_`` backward."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor):
        ctx.save_for_backward(idx)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return table[idx]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        acc = torch.zeros(ctx.table_shape, dtype=torch.float32,
                          device=grad.device)
        acc.index_add_(0, idx, grad.float())
        return acc.to(ctx.table_dtype), None


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(table, idx)
    return table[idx]


def _lerp(rows: torch.Tensor, w: torch.Tensor, wdt: torch.dtype
          ) -> torch.Tensor:
    """sum_k rows[m, k, c] * w[m, k] with operands rounded to ``wdt``,
    fp32 products and sum, one final rounding to ``wdt``."""
    out = (rows.to(wdt).float() * w.to(wdt).float()[..., None]).sum(1)
    return out.to(wdt)


def grid_sample_2d_packed(packed: torch.Tensor, shape: tuple[int, int],
                          uv: torch.Tensor,
                          lerp_dtype: torch.dtype | None = None
                          ) -> torch.Tensor:
    """Bilinear sample of a ``pack_corners_2d`` table of size (H, W) at
    uv (..., 2) in [0, 1] (u -> W, v -> H). Returns (..., C)."""
    H, W = shape
    C = packed.shape[-1] // 4
    out_shape = uv.shape[:-1]
    c = uv.reshape(-1, 2).float()
    fu = c[:, 0].clamp(0.0, 1.0) * (W - 1)
    fv = c[:, 1].clamp(0.0, 1.0) * (H - 1)
    u0 = torch.floor(fu).to(torch.int32).clamp(0, max(W - 2, 0))
    v0 = torch.floor(fv).to(torch.int32).clamp(0, max(H - 2, 0))
    tu = fu - u0
    tv = fv - v0
    rows = _gather_rows(packed, (v0 * W + u0).long()).reshape(-1, 4, C)
    w4 = torch.stack([(1 - tv) * (1 - tu), (1 - tv) * tu,
                      tv * (1 - tu), tv * tu], dim=-1)
    out = _lerp(rows, w4, lerp_dtype or packed.dtype)
    return out.reshape(*out_shape, C)


def grid_sample_3d_packed(packed: torch.Tensor,
                          shape: tuple[int, int, int], coords: torch.Tensor,
                          lerp_dtype: torch.dtype | None = None
                          ) -> torch.Tensor:
    """Trilinear sample of a ``pack_corners_3d`` table of size (D, H, W)
    at coords (..., 3) in [-1, 1], xyz order. Returns (..., C)."""
    D, H, W = shape
    C = packed.shape[-1] // 8
    out_shape = coords.shape[:-1]
    c = coords.reshape(-1, 3).float()

    def split(f, size):
        f = f.clamp(0.0, size - 1.0)
        i0 = torch.floor(f).to(torch.int32).clamp(0, max(size - 2, 0))
        return i0, f - i0

    x0, tx = split((c[:, 0] + 1.0) * 0.5 * (W - 1), W)
    y0, ty = split((c[:, 1] + 1.0) * 0.5 * (H - 1), H)
    z0, tz = split((c[:, 2] + 1.0) * 0.5 * (D - 1), D)
    rows = _gather_rows(packed, ((z0 * H + y0) * W + x0).long()) \
        .reshape(-1, 8, C)
    wx = torch.stack([1 - tx, tx], dim=-1)
    wy = torch.stack([1 - ty, ty], dim=-1)
    wz = torch.stack([1 - tz, tz], dim=-1)
    w8 = (wz[:, :, None, None] * wy[:, None, :, None]
          * wx[:, None, None, :]).reshape(-1, 8)
    out = _lerp(rows, w8, lerp_dtype or packed.dtype)
    return out.reshape(*out_shape, C)


def _lerp_shared(rows: torch.Tensor, w: torch.Tensor, wdt: torch.dtype
                 ) -> torch.Tensor:
    """sum_k rows[n, k, c] * w[q, n, k] -> (Q, N, C): operands rounded to
    ``wdt``, an fp32 contraction, one final rounding to ``wdt``."""
    return torch.einsum("nkc,qnk->qnc", rows.to(wdt).float(),
                        w.to(wdt).float()).to(wdt)


def grid_sample_2d_packed_shared(packed: torch.Tensor,
                                 shape: tuple[int, int],
                                 uv_ref: torch.Tensor, uv: torch.Tensor,
                                 lerp_dtype: torch.dtype | None = None
                                 ) -> torch.Tensor:
    """Bilinear sample of Q variants against one corner gather: ``uv_ref``
    (N, 2) picks each cell (one row), ``uv`` (Q, N, 2) lerp against it
    with weights relative to that cell, unclamped. Returns (Q, N, C)."""
    H, W = shape
    C = packed.shape[-1] // 4
    N = uv_ref.shape[0]
    cr = uv_ref.reshape(-1, 2).float()
    u0 = torch.floor(cr[:, 0].clamp(0.0, 1.0) * (W - 1)).to(torch.int32) \
        .clamp(0, max(W - 2, 0))
    v0 = torch.floor(cr[:, 1].clamp(0.0, 1.0) * (H - 1)).to(torch.int32) \
        .clamp(0, max(H - 2, 0))
    rows = _gather_rows(packed, (v0 * W + u0).long()).reshape(N, 4, C)
    c = uv.float()
    tu = c[..., 0].clamp(0.0, 1.0) * (W - 1) - u0[None]
    tv = c[..., 1].clamp(0.0, 1.0) * (H - 1) - v0[None]
    w4 = torch.stack([(1 - tv) * (1 - tu), (1 - tv) * tu,
                      tv * (1 - tu), tv * tu], dim=-1)      # (Q, N, 4)
    return _lerp_shared(rows, w4, lerp_dtype or packed.dtype)


def grid_sample_3d_packed_shared(packed: torch.Tensor,
                                 shape: tuple[int, int, int],
                                 coords_ref: torch.Tensor,
                                 coords: torch.Tensor,
                                 lerp_dtype: torch.dtype | None = None
                                 ) -> torch.Tensor:
    """Trilinear analog of ``grid_sample_2d_packed_shared``: ``coords_ref``
    (N, 3) in [-1, 1] (xyz) picks each cell, ``coords`` (Q, N, 3) trilerp
    against it with unclamped weights. Returns (Q, N, C)."""
    D, H, W = shape
    C = packed.shape[-1] // 8
    N = coords_ref.shape[0]
    cr = coords_ref.reshape(-1, 3).float()

    def base(f, size):
        f = f.clamp(0.0, size - 1.0)
        return torch.floor(f).to(torch.int32).clamp(0, max(size - 2, 0))

    x0 = base((cr[:, 0] + 1.0) * 0.5 * (W - 1), W)
    y0 = base((cr[:, 1] + 1.0) * 0.5 * (H - 1), H)
    z0 = base((cr[:, 2] + 1.0) * 0.5 * (D - 1), D)
    rows = _gather_rows(packed, ((z0 * H + y0) * W + x0).long()) \
        .reshape(N, 8, C)
    c = coords.float()
    tx = ((c[..., 0] + 1.0) * 0.5 * (W - 1)).clamp(0.0, W - 1.0) - x0[None]
    ty = ((c[..., 1] + 1.0) * 0.5 * (H - 1)).clamp(0.0, H - 1.0) - y0[None]
    tz = ((c[..., 2] + 1.0) * 0.5 * (D - 1)).clamp(0.0, D - 1.0) - z0[None]
    wx = torch.stack([1 - tx, tx], dim=-1)                  # (Q, N, 2)
    wy = torch.stack([1 - ty, ty], dim=-1)
    wz = torch.stack([1 - tz, tz], dim=-1)
    w8 = (wz[..., :, None, None] * wy[..., None, :, None]
          * wx[..., None, None, :]).reshape(*tx.shape, 8)
    return _lerp_shared(rows, w8, lerp_dtype or packed.dtype)


def grid_sample_3d(voxel: torch.Tensor, coords: torch.Tensor
                   ) -> torch.Tensor:
    """Trilinear sample of a (C, D, H, W) voxel at coords (..., 3) in
    [-1, 1] (xyz order), align-corners, border padding: eight corner
    gathers and JAX's lerp order. Returns (..., C)."""
    C, D, H, W = voxel.shape
    shape = coords.shape[:-1]
    c = coords.reshape(-1, 3).float()

    def split(f, size):
        f = f.clamp(0.0, size - 1.0)
        i0 = (torch.floor(f).to(torch.int64).clamp(0, size - 2) if size > 1
              else torch.zeros_like(f, dtype=torch.int64))
        return i0, f - i0

    x0, tx = split((c[:, 0] + 1.0) * 0.5 * (W - 1), W)
    y0, ty = split((c[:, 1] + 1.0) * 0.5 * (H - 1), H)
    z0, tz = split((c[:, 2] + 1.0) * 0.5 * (D - 1), D)
    flat = voxel.reshape(C, D * H * W)

    def gather(z, y, x):
        return flat[:, (z * H + y) * W + x]                  # (C, M)

    c00 = gather(z0, y0, x0) * (1 - tx) + gather(z0, y0, x0 + 1) * tx
    c01 = gather(z0, y0 + 1, x0) * (1 - tx) + gather(z0, y0 + 1, x0 + 1) * tx
    c10 = gather(z0 + 1, y0, x0) * (1 - tx) + gather(z0 + 1, y0, x0 + 1) * tx
    c11 = (gather(z0 + 1, y0 + 1, x0) * (1 - tx)
           + gather(z0 + 1, y0 + 1, x0 + 1) * tx)
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return (c0 * (1 - tz) + c1 * tz).t().reshape(*shape, C)
