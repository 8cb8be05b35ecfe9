"""Multi-resolution hash-grid encoding (Instant-NGP).

Port of ``instantavatar_tpu/ops/hashgrid.py``: L levels of F features in
one (L, T, F) table, level l at resolution floor(base * scale^l). A level
whose dense lattice fits in the table ((res + 1)^3 <= T) is indexed
densely, x + y (res + 1) + z (res + 1)^2; the finer ones are hashed,
(x * 1) ^ (y * 2654435761) ^ (z * 805459861) mod T. The choice is static
per level: at the default 16 x 2 @ 2^19 (resolutions 16, 24, 36, 54, 81
... 7006) levels 0-3 are dense and 4-15 hashed.

JAX hashes in uint32, which wraps. PyTorch has no general uint32
arithmetic on CUDA, so the products are taken in int64 (the largest,
7006 * 2654435761 ~ 1.9e13, is far below 2^63) and XORed; masking with
T - 1 then keeps the same low log2(T) bits as the wrapped uint32 hash.
Clamping, corner order and trilinear weights follow JAX exactly, in fp32.

``hash_encode`` dispatches by device: CPU tensors run the plain version
``hash_encode_ref``; CUDA tensors run the hand-written kernel
(``kernels/hash_encode.py``, ``csrc/hash_encode.cu``), forward and
backward, or the call raises. Nothing falls back from one to the other.

The plain version encodes all levels at once: the slots of every (point,
level, corner) index one flat (L * T, F) view of the table, gathered
through ``_GatherRows`` (the table's gradient is an fp32 ``index_add_``;
the default backward of ``table[idx]`` walks duplicate indices serially).
Rows go through in chunks of ``chunk`` (about 3 KB of temporaries per row
at the default config), so a 2M-row frame needs no 6 GB index tensor.
``hash_encode_backward_ref`` is the kernels' closed-form backward in
plain torch: the table's gradient by ``index_add_``, and the points'
gradient with JAX's clip derivative.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from ..kernels.hash_encode import hash_encode_cuda
from ..utils.device_const import device_constant
from .grid_sample import _gather_rows

__all__ = ["HashGridConfig", "level_resolutions", "init_hash_table",
           "hash_slots", "hash_encode", "hash_encode_ref",
           "hash_encode_backward_ref"]

# spatial-hash primes (Instant-NGP / Teschner et al.)
_PRIMES = (1, 2654435761, 805459861)
_CHUNK = 1 << 19


class HashGridConfig(NamedTuple):
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.5

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def level_resolutions(cfg: HashGridConfig) -> list[int]:
    """Per-level grid resolution: floor(base * scale^l)."""
    return [int(math.floor(cfg.base_resolution * cfg.per_level_scale ** l))
            for l in range(cfg.n_levels)]


def init_hash_table(generator: torch.Generator, cfg: HashGridConfig, *,
                    device: torch.device | str | None = None
                    ) -> torch.Tensor:
    """(L, T, F) fp32 table, uniform in [-1e-4, 1e-4], drawn from
    ``generator`` (on its device) and moved to ``device``."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features),
                   generator=generator, device=generator.device)
    return (u * 2e-4 - 1e-4).to(device or generator.device)


def _level_constants(cfg: HashGridConfig, resolutions: Sequence[int],
                     device) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Per level: resolution as fp32 and int64 (L,), the per-axis
    multipliers (L, 3) (strides of a dense level, primes of a hashed one)
    and whether the level is dense (L,)."""
    T = cfg.table_size
    mult, dense = [], []
    for res in resolutions:
        d = (res + 1) ** 3 <= T
        dense.append(d)
        mult.append((1, res + 1, (res + 1) ** 2) if d else _PRIMES)
    res_i = device_constant(list(resolutions), torch.int64, device)
    return (device_constant(list(resolutions), torch.float32, device),
            res_i, device_constant(mult, torch.int64, device),
            device_constant(dense, torch.bool, device))


def _slots_weights(x: torch.Tensor, cfg: HashGridConfig, consts
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Points (N, 3) -> per (point, level, corner) the row of the flat
    (L * T, F) table, int32 (N, L, 8), and the trilinear weight, fp32
    (N, L, 8); and the cell fractions, fp32 (N, L, 3). Corner c = 4 i + 2
    j + k takes offset (i, j, k) on (x, y, z), JAX's order."""
    res_f, res_i, mult, dense = consts
    L, T = cfg.n_levels, cfg.table_size
    # jnp.clip as min(max(x, 0), 1): half the gradient on the boundary
    zero = x.new_zeros(())
    x = torch.minimum(torch.maximum(x, zero), zero + 1.0)
    pos = x[:, None, :] * res_f[None, :, None]                 # (N, L, 3)
    cell = torch.floor(pos)
    frac = pos - cell
    base = torch.minimum(cell.to(torch.int64).clamp_min(0),
                         res_i[None, :, None])
    lim = res_i[None, :, None, None]
    c = torch.minimum(torch.stack([base, base + 1], -1), lim)  # (N,L,3,2)
    t = c * mult[None, :, :, None]
    tx, ty, tz = t[:, :, 0], t[:, :, 1], t[:, :, 2]             # (N, L, 2)
    add = (tx[..., :, None, None] + ty[..., None, :, None]
           + tz[..., None, None, :])
    xor = (tx[..., :, None, None] ^ ty[..., None, :, None]
           ^ tz[..., None, None, :])
    slot = torch.where(dense[None, :, None, None, None], add, xor) & (T - 1)
    level0 = torch.arange(L, dtype=torch.int64, device=x.device) * T
    slots = (slot.reshape(-1, L, 8) + level0[None, :, None]).to(torch.int32)
    w = torch.stack([1.0 - frac, frac], -1)                     # (N,L,3,2)
    wx, wy, wz = w[:, :, 0], w[:, :, 1], w[:, :, 2]
    weights = (wx[..., :, None, None] * wy[..., None, :, None]
               * wz[..., None, None, :]).reshape(-1, L, 8)
    return slots, weights, frac


def hash_slots(x: torch.Tensor, cfg: HashGridConfig,
               resolutions: Sequence[int] | None = None) -> torch.Tensor:
    """Points (..., 3) -> each level's table slot of each corner, int64
    (..., L, 8) in [0, T) (the flat row minus l * T)."""
    res = resolutions or level_resolutions(cfg)
    consts = _level_constants(cfg, res, x.device)
    slots, _, _ = _slots_weights(x.reshape(-1, 3).float(), cfg, consts)
    level0 = torch.arange(cfg.n_levels, device=x.device) * cfg.table_size
    return (slots.long() - level0[None, :, None]).reshape(
        *x.shape[:-1], cfg.n_levels, 8)


def hash_encode(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig,
                resolutions: Sequence[int] | None = None, *,
                chunk: int = _CHUNK) -> torch.Tensor:
    """Encode points x (..., 3) in [0, 1]^3 (clamped) with the (L, T, F)
    table -> (..., L * F) features, level-major, differentiable in the
    table and in x. CPU tensors run ``hash_encode_ref`` (in row chunks of
    ``chunk``); anything else runs the CUDA kernel or raises."""
    res = resolutions or level_resolutions(cfg)
    if table.device.type == "cpu" and x.device.type == "cpu":
        return hash_encode_ref(table, x, cfg, res, chunk=chunk)
    out = hash_encode_cuda(table, x.reshape(-1, 3).float().contiguous(), res)
    return out.reshape(*x.shape[:-1], cfg.out_dim)


def hash_encode_ref(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig,
                    resolutions: Sequence[int] | None = None, *,
                    chunk: int = _CHUNK) -> torch.Tensor:
    """The plain PyTorch version of ``hash_encode``, on any device: points
    x (..., 3) -> (..., L * F), differentiable in the table and in x."""
    res = resolutions or level_resolutions(cfg)
    consts = _level_constants(cfg, res, x.device)
    L, F = cfg.n_levels, cfg.n_features
    flat = table.reshape(L * cfg.table_size, F)
    xf = x.reshape(-1, 3).float()
    outs = []
    for s in range(0, max(xf.shape[0], 1), chunk):
        slots, w, _ = _slots_weights(xf[s:s + chunk], cfg, consts)
        rows = _gather_rows(flat, slots.reshape(-1)).reshape(*w.shape, F)
        outs.append((rows * w[..., None]).sum(2).reshape(-1, L * F))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.reshape(*x.shape[:-1], L * F)


def hash_encode_backward_ref(table: torch.Tensor, x: torch.Tensor,
                             grad_out: torch.Tensor, cfg: HashGridConfig,
                             resolutions: Sequence[int] | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' backward in closed form, plain torch, no autograd:
    (table (L, T, F), points x (..., 3), the features' gradient (..., L *
    F)) -> (the table's gradient (L, T, F), the points' gradient (...,
    3)). The table's gradient is an fp32 ``index_add_`` of w_c * g per
    corner. The points': res * sum_c dw_c / dfrac . <row_c, g> over the
    levels, times JAX's clip derivative (1 inside (0, 1), 0.5 at exactly
    0 or 1, 0 outside)."""
    res = resolutions or level_resolutions(cfg)
    consts = _level_constants(cfg, res, x.device)
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    xf = x.reshape(-1, 3).float()
    g = grad_out.reshape(-1, L, F).float()
    slots, w, frac = _slots_weights(xf, cfg, consts)        # (N, L, 8)
    rows = slots.reshape(-1).long()
    contrib = (w[..., None] * g[:, :, None, :]).reshape(-1, F)
    grad_table = torch.zeros((L * T, F), device=x.device).index_add_(
        0, rows, contrib)
    vals = table.reshape(L * T, F)[rows].reshape(*w.shape, F)
    dot = (vals * g[:, :, None, :]).sum(-1)                  # (N, L, 8)
    wa = torch.stack([1.0 - frac, frac], -1)                 # (N, L, 3, 2)
    wx, wy, wz = wa[:, :, 0], wa[:, :, 1], wa[:, :, 2]        # (N, L, 2)
    sign = torch.tensor([-1.0, 1.0], device=x.device)
    dw = torch.stack([
        sign[:, None, None] * wy[..., None, :, None] * wz[..., None, None, :],
        wx[..., :, None, None] * sign[None, :, None] * wz[..., None, None, :],
        wx[..., :, None, None] * wy[..., None, :, None] * sign[None, None, :],
    ], -1).reshape(*w.shape, 3)                               # (N, L, 8, 3)
    res_f = consts[0]
    gx = ((dw * dot[..., None]).sum(2) * res_f[None, :, None]).sum(1)
    clip_d = torch.where((xf > 0) & (xf < 1), 1.0,
                         torch.where((xf == 0) | (xf == 1), 0.5, 0.0))
    return (grad_table.reshape(L, T, F),
            (gx * clip_d).reshape(x.shape))
