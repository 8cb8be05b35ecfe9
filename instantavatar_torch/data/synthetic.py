"""Synthetic avatar sequences (the repo's own training scenes).

Port of ``instantavatar_tpu/data/synthetic.py``. ``render_capsule_frame``
ray-traces one capsule per bone of the posed toy body (exact
intersections, Lambert shading with per-bone albedo and a light that
follows each bone's full rest->posed rotation, supersampled coverage),
with the math of the JAX tracers on the caller's device, in fp32 (the
jitted tracer) or float64 (the numpy one). Every dot product is written
out as three multiply-adds: the capsule discriminant cancels two ~0.56
terms down to ~1e-4, which TF32 or bf16 products would destroy.

``make_synthetic_sequence`` writes a sequence directory (cameras.npz,
images/*.png, masks/*.npy, poses.npz) in the ``splat`` style (a painter's
splat of per-vertex discs, rasterized as ``cv2.circle`` fills them) or the
``capsule`` style, through ``utils.image_io``. ``make_capsule_sequence``
makes the poses and capsule frames as arrays instead; its images are
quantized to 8 bits as the PNG round trip does.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..body import smpl_forward, toy_smpl_model
from ..utils.image_io import write_png

__all__ = ["render_capsule_frame", "make_capsule_sequence",
           "make_synthetic_sequence"]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot of (..., 3) tensors, in fp32 multiply-adds."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _capsule_shade(joints, p_idx, c_idx, albedo, lights, K, H: int, W: int,
                   ss: int, radius: float):
    dev, dt = joints.device, joints.dtype
    u = (torch.arange(W * ss, device=dev, dtype=dt) + 0.5) / ss - 0.5
    v = (torch.arange(H * ss, device=dev, dtype=dt) + 0.5) / ss - 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack([(uu - K[0, 2] + 0.5) / K[0, 0],
                     (vv - K[1, 2] + 0.5) / K[1, 1],
                     torch.ones_like(uu)], dim=-1).reshape(-1, 3)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    p0, p1 = joints[p_idx], joints[c_idx]                   # (B, 3)
    r2 = (float(np.float32(radius) ** 2) if dt == torch.float32
          else radius ** 2)
    ba, oa = p1 - p0, -p0
    baba, baoa, oaoa = _dot(ba, ba), _dot(ba, oa), _dot(oa, oa)
    dr = d[:, None, :]                                       # (R, 1, 3)
    bard, rdoa = _dot(dr, ba), _dot(dr, oa)                  # (R, B)
    a = baba - bard ** 2
    b = baba * rdoa - baoa * bard
    c = baba * oaoa - baoa ** 2 - r2 * baba
    h = b * b - a * c
    a = a.clamp_min(1e-12)
    t_cyl = (-b - torch.sqrt(h.clamp_min(0.0))) / a
    y = baoa + t_cyl * bard
    cyl_ok = (h > 0) & (y > 0) & (y < baba) & (t_cyl > 0)
    inf = torch.full_like(t_cyl, float("inf"))
    t = torch.where(cyl_ok, t_cyl, inf)
    for pc in (p0, p1):
        oc = -pc
        bq = _dot(dr, oc)
        hq = bq * bq - (_dot(oc, oc) - r2)
        t_sph = -bq - torch.sqrt(hq.clamp_min(0.0))
        t = torch.where((hq > 0) & (t_sph > 0), torch.minimum(t, t_sph), t)
    tmin, bone = t.min(dim=1)
    hit = torch.isfinite(tmin)
    pa = d * torch.where(hit, tmin, torch.ones_like(tmin))[:, None]
    a0 = p0[bone]
    ax = p1[bone] - a0
    yy2 = _dot(pa - a0, ax) / _dot(ax, ax).clamp_min(1e-12)
    foot = a0 + yy2.clamp(0.0, 1.0)[:, None] * ax
    nrm = pa - foot
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True).clamp_min(1e-12)
    lam = 0.35 + 0.65 * (-_dot(nrm, lights[bone])).clamp_min(0.0)
    img = albedo[c_idx][bone] * lam[:, None] * hit[:, None]
    img = img.reshape(H, ss, W, ss, 3).mean(dim=(1, 3))
    msk = hit.to(dt).reshape(H, ss, W, ss).mean(dim=(1, 3))
    img = img / msk[..., None].clamp_min(1e-6)
    return img * (msk[..., None] > 0), msk


def render_capsule_frame(joints, parents: np.ndarray, K: np.ndarray, H: int,
                         W: int, radius: float = 0.06, ss: int = 3,
                         seed: int = 0, bone_rots=None, *,
                         device: torch.device | str,
                         dtype: torch.dtype = torch.float32
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ray-trace the posed capsule body seen from a camera at the origin.

    Args:
      joints: (J, 3) posed joints in camera coords (+z forward).
      parents: (J,) kinematic parents (bone b = segment parent -> joint).
      bone_rots: (J, 3, 3) full rest->posed rotation per joint; bone b's
        light turns with its parent joint, which makes the shading
        pose-invariant in canonical space. None keeps one world light.
    Returns (img (H, W, 3) unpremultiplied body colour, msk (H, W)
    coverage), tensors of ``dtype`` on ``device``.
    """
    parents = np.asarray(parents)
    bones = np.arange(1, len(parents))
    rng = np.random.RandomState(seed)
    albedo = rng.rand(len(parents), 3) * 0.6 + 0.35     # per-bone colour
    light = np.array([0.35, -0.5, 0.79])
    light /= np.linalg.norm(light)
    if bone_rots is not None:
        rots = (bone_rots.detach().cpu().double().numpy()
                if torch.is_tensor(bone_rots)
                else np.asarray(bone_rots, np.float64))
        lights = np.einsum("bij,j->bi", rots[parents[bones], :3, :3], light)
    else:
        lights = np.broadcast_to(light, (len(bones), 3))
    lights = lights.astype(np.float32)       # as both JAX tracers take them

    def t(a):
        return torch.as_tensor(np.array(
            a, np.float64 if dtype == torch.float64 else np.float32),
            device=device).to(dtype)

    return _capsule_shade(
        joints.to(device, torch.float32).to(dtype) if torch.is_tensor(joints)
        else t(joints),
        torch.as_tensor(parents[bones], device=device),
        torch.as_tensor(bones, device=device), t(albedo), t(lights), t(K),
        H, W, ss, float(radius))


def _sequence(n_frames: int, H: int, W: int, ring_size: int, seed: int,
              distance: float, bone_rings: int, device):
    """The synthetic sequence's camera, poses and posed toy body: identity
    camera at the origin with focal W, the body at (0, 0, distance),
    shoulders swinging and a slow yaw."""
    model = toy_smpl_model(ring_size=ring_size, seed=seed,
                           bone_rings=bone_rings, device=device)
    f = float(W)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float64)
    betas = np.zeros((1, 10), np.float32)
    body_pose = np.zeros((n_frames, 69), np.float32)
    t = np.arange(n_frames, dtype=np.float32)
    body_pose[:, 45 + 2] = 0.5 * np.sin(t * 0.7)       # L shoulder z
    body_pose[:, 48 + 2] = -0.5 * np.sin(t * 0.7)      # R shoulder z
    global_orient = np.zeros((n_frames, 3), np.float32)
    global_orient[:, 1] = 0.3 * np.sin(t * 0.5)        # slow yaw
    transl = np.tile(np.array([[0.0, 0.0, distance]], np.float32),
                     (n_frames, 1))
    params = {"betas": betas, "body_pose": body_pose,
              "global_orient": global_orient, "transl": transl}
    with torch.no_grad():
        out = smpl_forward(model, *(torch.as_tensor(params[k], device=device)
                                    for k in ("betas", "body_pose",
                                              "global_orient", "transl")))
    return model, K, params, out


def make_capsule_sequence(n_frames: int = 8, H: int = 64, W: int = 64,
                          ring_size: int = 8, seed: int = 0,
                          distance: float = 3.0, bone_rings: int = 0, *,
                          device: torch.device | str) -> dict:
    """Frames and poses of ``make_synthetic_sequence(style="capsule")``
    as numpy arrays: images (F, H, W, 3) (8-bit steps), masks (F, H, W),
    K, c2w and smpl_params (betas (1, 10), body_pose, global_orient,
    transl)."""
    model, K, params, out = _sequence(n_frames, H, W, ring_size, seed,
                                      distance, bone_rings, device)
    imgs, msks = [], []
    with torch.no_grad():
        for i in range(n_frames):
            img, msk = render_capsule_frame(
                out.joints[i], model.parents, K, H, W, radius=0.07, ss=3,
                seed=seed, bone_rots=out.A[i, :, :3, :3], device=device)
            imgs.append(torch.floor(img * 255.0) / 255.0)
            msks.append(msk)
    return {"images": torch.stack(imgs).cpu().numpy(),
            "masks": torch.stack(msks).cpu().numpy(),
            "K": K, "c2w": np.eye(4), "smpl_params": params}


def _circle_rows(radius: int) -> dict[int, int]:
    """Row offset -> half-width of a filled ``cv2.circle`` (8-connected,
    integer centre and radius): its midpoint walk, every span it fills."""
    rows: dict[int, int] = {}
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for ry, hw in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            rows[ry] = max(rows.get(ry, -1), hw)
        dy += 1
        err += plus
        plus += 2
        mask = int(err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return rows


def _splat_frame(verts: np.ndarray, colors: np.ndarray, K: np.ndarray,
                 H: int, W: int, radius: int) -> tuple[np.ndarray, np.ndarray]:
    """Painter's splat of per-vertex discs, far to near."""
    img = np.zeros((H, W, 3), np.float32)
    msk = np.zeros((H, W), np.float32)
    rows = _circle_rows(radius)
    for i in np.argsort(-verts[:, 2]):
        x, y, z = verts[i]
        if z <= 0.1:
            continue
        u = int(round(K[0, 0] * x / z + K[0, 2]))
        v = int(round(K[1, 1] * y / z + K[1, 2]))
        if 0 <= u < W and 0 <= v < H:
            for ry, hw in rows.items():
                if 0 <= v + ry < H:
                    x0, x1 = max(u - hw, 0), min(u + hw, W - 1)
                    img[v + ry, x0:x1 + 1] = colors[i]
                    msk[v + ry, x0:x1 + 1] = 1.0
    return img, msk


def make_synthetic_sequence(root: str | Path, n_frames: int = 8,
                            H: int = 64, W: int = 64,
                            ring_size: int = 8, seed: int = 0,
                            distance: float = 3.0,
                            style: str = "splat",
                            bone_rings: int = 0, *,
                            device: torch.device | str) -> Path:
    """Write a synthetic sequence directory; returns it.

    Camera: identity extrinsics (camera at the origin, z forward), focal
    W. Body: the toy SMPL at (0, 0, distance), shoulders swinging and a
    slow yaw. The capsule tracer runs in float64 up to 2^17 supersamples
    per frame and in fp32 above, as the JAX writer picks its tracer.
    """
    if style not in ("splat", "capsule"):
        raise ValueError(f"unknown style {style!r}")
    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "masks").mkdir(parents=True, exist_ok=True)
    model, K, params, out = _sequence(n_frames, H, W, ring_size, seed,
                                      distance, bone_rings, device)
    np.savez(root / "cameras.npz", intrinsic=K, extrinsic=np.eye(4),
             height=H, width=W)
    colors = (np.random.RandomState(seed).rand(model.num_verts, 3)
              .astype(np.float32) * 0.7 + 0.3)
    verts = out.vertices.cpu().numpy()
    dtype = torch.float64 if H * W * 9 <= 1 << 17 else torch.float32
    radius = max(1, int(0.06 * W / distance))
    for i in range(n_frames):
        if style == "capsule":
            img, msk = render_capsule_frame(
                out.joints[i], model.parents, K, H, W, radius=0.07, ss=3,
                seed=seed, bone_rots=out.A[i, :, :3, :3], device=device,
                dtype=dtype)
            img = img.float().cpu().numpy()
            msk = msk.float().cpu().numpy()
        else:
            img, msk = _splat_frame(verts[i], colors, K, H, W, radius)
        # written as BGR and read back as BGR, like cv2's round trip
        write_png(root / f"images/{i:04d}.png", (img * 255).astype(np.uint8))
        np.save(root / f"masks/{i:04d}.npy", msk)
    np.savez(root / "poses.npz", **params)
    return root
