"""Field -> mesh extraction without skimage or trimesh.

Port of ``instantavatar_tpu/utils/marching_cubes.py`` (numpy, copied):
a density field evaluated on a lattice in chunks, the midpoint-
interpolated marching-tetrahedra isosurface (each cube split into 6
tetrahedra: simpler tables than full marching cubes, watertight), the
largest face-connected component, and OBJ export. ``field_to_mesh``
evaluates a torch density function.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

__all__ = ["marching_tetrahedra", "field_to_mesh", "save_obj",
           "largest_mesh_component"]

# 6 tetrahedra per cube (corner indices in dz*4+dy*2+dx bit order)
_TETS = np.array([
    [0, 5, 1, 3], [0, 5, 3, 7], [0, 5, 7, 4],
    [0, 3, 2, 7], [0, 7, 6, 4], [0, 2, 6, 7],
], np.int32)

_CORNERS = np.array([[dz, dy, dx] for dz in (0, 1) for dy in (0, 1)
                     for dx in (0, 1)], np.int32)


def marching_tetrahedra(volume: np.ndarray, level: float = 0.0,
                        spacing: tuple = (1.0, 1.0, 1.0),
                        origin: tuple = (0.0, 0.0, 0.0)):
    """Extract the ``volume == level`` isosurface.

    Args:
      volume: (D, H, W) scalar field.
      level: iso value.

    Returns:
      verts (M, 3) float32 (z, y, x order scaled by spacing + origin),
      faces (F, 3) int32.
    """
    D, H, W = volume.shape
    v = volume - level

    # cube corner values: (D-1, H-1, W-1, 8)
    cz, cy, cx = np.meshgrid(np.arange(D - 1), np.arange(H - 1),
                             np.arange(W - 1), indexing="ij")
    corner_vals = np.stack(
        [v[cz + dz, cy + dy, cx + dx] for dz, dy, dx in _CORNERS], axis=-1)
    corner_pos = np.stack(
        [np.stack([cz + dz, cy + dy, cx + dx], axis=-1)
         for dz, dy, dx in _CORNERS], axis=-2)  # (..., 8, 3)

    cells = corner_vals.reshape(-1, 8)
    pos = corner_pos.reshape(-1, 8, 3).astype(np.float32)
    # skip cubes with no crossing
    active = ~((cells > 0).all(-1) | (cells <= 0).all(-1))
    cells, pos = cells[active], pos[active]

    tris = []
    for tet in _TETS:
        tv = cells[:, tet]                      # (N, 4)
        tp = pos[:, tet]                        # (N, 4, 3)
        inside = tv > 0                         # (N, 4)
        n_in = inside.sum(-1)

        def edge_point(a, b):
            """Interpolated crossing on edge a-b (indices into tet)."""
            va, vb = tv[:, a], tv[:, b]
            t = va / np.where(np.abs(va - vb) < 1e-12, 1e-12, va - vb)
            t = np.clip(t, 0.0, 1.0)[:, None]
            return tp[:, a] * (1 - t) + tp[:, b] * t

        for k in (1, 3):  # one corner inside (k=1) or outside (k=3)
            mask = n_in == k
            if not mask.any():
                continue
            want_inside = k == 1
            # the lone corner
            lone = np.argmax(inside == want_inside, axis=-1)
            others = np.array([[j for j in range(4) if j != i]
                               for i in range(4)])
            oth = others[lone]                  # (N, 3)
            p = [edge_point_dyn(tv, tp, lone, oth[:, j]) for j in range(3)]
            tri = np.stack(p, axis=1)[mask]
            if not want_inside:
                tri = tri[:, ::-1]
            tris.append(tri)

        mask = n_in == 2
        if mask.any():
            # quad between the two inside and two outside corners
            order = np.argsort(~inside, axis=-1)   # inside first
            i0, i1 = order[:, 0], order[:, 1]
            o0, o1 = order[:, 2], order[:, 3]
            p00 = edge_point_dyn(tv, tp, i0, o0)
            p01 = edge_point_dyn(tv, tp, i0, o1)
            p10 = edge_point_dyn(tv, tp, i1, o0)
            p11 = edge_point_dyn(tv, tp, i1, o1)
            t1 = np.stack([p00, p01, p10], axis=1)[mask]
            t2 = np.stack([p10, p01, p11], axis=1)[mask]
            tris.append(t1)
            tris.append(t2)

    if not tris:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    tri = np.concatenate(tris, axis=0)          # (F, 3, 3)
    # weld vertices
    flat = tri.reshape(-1, 3)
    key = np.round(flat / 1e-5).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3), np.float32)
    verts[inv] = flat
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    faces = faces[ok]
    verts = verts * np.asarray(spacing, np.float32) \
        + np.asarray(origin, np.float32)
    return verts, faces


def edge_point_dyn(tv, tp, a_idx, b_idx):
    """edge_point with per-row corner indices (a_idx, b_idx (N,))."""
    rows = np.arange(len(tv))
    va, vb = tv[rows, a_idx], tv[rows, b_idx]
    pa, pb = tp[rows, a_idx], tp[rows, b_idx]
    t = va / np.where(np.abs(va - vb) < 1e-12, 1e-12, va - vb)
    t = np.clip(t, 0.0, 1.0)[:, None]
    return pa * (1 - t) + pb * t


def largest_mesh_component(verts: np.ndarray, faces: np.ndarray):
    """Keep the largest face-connected component (marching_cubes.py:
    keep-largest behavior) via union-find over shared vertices."""
    parent = np.arange(len(verts))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for f in faces:
        a = find(f[0])
        for v in f[1:]:
            b = find(v)
            parent[b] = a
    roots = np.array([find(v) for v in range(len(verts))])
    face_root = roots[faces[:, 0]]
    vals, counts = np.unique(face_root, return_counts=True)
    keep_root = vals[np.argmax(counts)]
    keep_faces = faces[face_root == keep_root]
    used = np.unique(keep_faces)
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[keep_faces].astype(np.int32)


def field_to_mesh(density_fn, aabb, resolution: int = 128,
                  level: float = 0.0, chunk: int = 65536,
                  keep_largest: bool = True, *,
                  device: torch.device | str):
    """Evaluate a torch density function (pts (M, 3) fp32 on ``device`` ->
    (M,)) on a resolution^3 lattice over ``aabb``, ``chunk`` points at a
    time, and extract the ``level`` set: (verts (V, 3) xyz, faces (F, 3)),
    keeping the largest component unless ``keep_largest`` is False."""
    aabb = np.asarray(aabb, np.float32)
    axes = [np.linspace(aabb[0][i], aabb[1][i], resolution)
            for i in range(3)]
    zz, yy, xx = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    vals = []
    with torch.no_grad():
        for i in range(0, len(pts), chunk):
            vals.append(density_fn(torch.as_tensor(
                pts[i:i + chunk], device=device)).float().cpu().numpy())
    volume = np.concatenate(vals).reshape(resolution, resolution,
                                          resolution)
    spacing = (aabb[1] - aabb[0]) / (resolution - 1)
    verts, faces = marching_tetrahedra(
        volume, level, spacing=(spacing[2], spacing[1], spacing[0]),
        origin=(aabb[0][2], aabb[0][1], aabb[0][0]))
    # (z, y, x) -> (x, y, z)
    verts = verts[:, ::-1].copy()
    if keep_largest and len(faces):
        verts, faces = largest_mesh_component(verts, faces)
    return verts, faces


def save_obj(path: str | Path, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")
