"""Point-to-triangle-mesh signed distance.

Port of ``instantavatar_tpu/ops/mesh_distance.py`` (the reference's
kaolin ``point_to_mesh_distance`` + ``check_sign`` for smpl-initialized
occupancy grids): brute force over all faces for chunks of query points,
the exact point-triangle distance by clamped barycentrics and three
clamped edge projections, the sign from the nearest face's normal (the
pseudo-normal test for watertight meshes such as SMPL's).
"""
from __future__ import annotations

import torch

__all__ = ["point_triangle_distance", "signed_distance_to_mesh"]


def point_triangle_distance(p: torch.Tensor, tri: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """All-pairs distance from points p (M, 3) to triangles tri (F, 3, 3):
    (squared distance (M, F), closest point (M, F, 3))."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]            # (F, 3)
    ab, ac = b - a, c - a
    ap = p[:, None] - a[None]                             # (M, F, 3)
    d1 = torch.einsum("fc,mfc->mf", ab, ap)
    d2 = torch.einsum("fc,mfc->mf", ac, ap)
    d00 = torch.einsum("fc,fc->f", ab, ab)[None]
    d01 = torch.einsum("fc,fc->f", ab, ac)[None]
    d11 = torch.einsum("fc,fc->f", ac, ac)[None]
    denom = d00 * d11 - d01 * d01
    ok = denom > 1e-12
    v = torch.where(ok, (d11 * d1 - d01 * d2) / denom, torch.zeros_like(d1))
    w = torch.where(ok, (d00 * d2 - d01 * d1) / denom, torch.zeros_like(d1))
    inside = (v >= 0) & (w >= 0) & (v + w <= 1)

    def edge_t(pa, e, ee):
        return (torch.einsum("mfc,fc->mf", pa, e)
                / ee.clamp_min(1e-12)).clamp(0.0, 1.0)

    t_ab = edge_t(ap, ab, d00[0])
    q_ab = a[None] + t_ab[..., None] * ab[None]
    t_ac = edge_t(ap, ac, d11[0])
    q_ac = a[None] + t_ac[..., None] * ac[None]
    bc = c - b
    bp = p[:, None] - b[None]
    t_bc = edge_t(bp, bc, torch.einsum("fc,fc->f", bc, bc))
    q_bc = b[None] + t_bc[..., None] * bc[None]
    q_in = a[None] + v[..., None] * ab[None] + w[..., None] * ac[None]

    d_ab = ((p[:, None] - q_ab) ** 2).sum(-1)
    d_ac = ((p[:, None] - q_ac) ** 2).sum(-1)
    d_bc = ((p[:, None] - q_bc) ** 2).sum(-1)
    d_edge = torch.minimum(torch.minimum(d_ab, d_ac), d_bc)
    q_edge = torch.where(((d_ab <= d_ac) & (d_ab <= d_bc))[..., None], q_ab,
                         torch.where((d_ac <= d_bc)[..., None], q_ac, q_bc))
    d_in = ((p[:, None] - q_in) ** 2).sum(-1)
    return (torch.where(inside, d_in, d_edge),
            torch.where(inside[..., None], q_in, q_edge))


def signed_distance_to_mesh(pts: torch.Tensor, verts: torch.Tensor,
                            faces, chunk: int = 2048) -> torch.Tensor:
    """Signed distance (M,) of pts (M, 3) to the mesh (verts (V, 3),
    faces (F, 3) int), negative inside; ``chunk`` points at a time bound
    the (chunk, F) buffers."""
    faces = torch.as_tensor(faces, device=verts.device).long()
    tri = verts[faces]                                    # (F, 3, 3)
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    out = []
    for c0 in range(0, pts.shape[0], chunk):
        p = pts[c0:c0 + chunk]
        dist_sq, closest = point_triangle_distance(p, tri)
        f_idx = dist_sq.argmin(-1)
        rows = torch.arange(p.shape[0], device=p.device)
        d = dist_sq[rows, f_idx].sqrt()
        sign = torch.sign(((p - closest[rows, f_idx]) * n[f_idx]).sum(-1))
        out.append(torch.where(sign == 0, torch.ones_like(sign), sign) * d)
    return torch.cat(out) if out else pts.new_zeros((0,))
