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
           "grid_sample_3d_packed"]


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


