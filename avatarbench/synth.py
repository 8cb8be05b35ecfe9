"""The benchmark's own inputs: poses, cameras and the synthetic capsule
frames that the training cell learns from.

The capsule tracer is a frozen copy of the port's ``render_capsule_frame``
(``data/synthetic.py``): one capsule per bone of the posed toy body, exact
intersections, Lambert shading with per-bone albedo and a light that turns
with each bone, supersampled coverage, fp32 multiply-adds written out. It
runs on the device, a few frames per call; the body is the reference's
frozen copy, so nothing here comes from the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["motion", "capsule_frames", "pinhole", "ray_basis"]


def motion(spec: list, t: np.ndarray, seed: int, cycle: int) -> np.ndarray:
    """Body poses (len(t), 69) of a smooth looping motion: for each
    ``[index, amplitude, period, phase]`` of ``spec`` the pose entry
    ``index`` swings as amplitude * sin(2 pi (t + offset) / period +
    phase). The seed draws only the offset, a whole frame in [0,
    ``cycle``): with every period dividing ``cycle`` (or far longer than
    a run, a slow drift that keeps any two frames' poses apart), every
    seed's frames run through the same poses, from another start."""
    offset = np.random.default_rng(seed).integers(0, cycle)
    poses = np.zeros((len(t), 69), np.float32)
    for index, amp, period, phase in spec:
        poses[:, int(index)] += amp * np.sin(
            2 * np.pi * (t + offset) / period + phase)
    return poses


def pinhole(focal: float, H: int, W: int) -> np.ndarray:
    return np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                    np.float64)


def ray_basis(K: np.ndarray) -> np.ndarray:
    """(4, 3) [o, b0, bx, by] of a camera at the origin looking down +z:
    pixel (x, y) looks along b0 + x bx + y by (the port's batch key
    ``ray_basis``)."""
    Kinv = np.linalg.inv(K)
    cols = np.stack([[0, 0, 1.0], [1, 0, 0], [0, 1, 0]]) @ Kinv.T
    return np.concatenate([np.zeros((1, 3)), cols]).astype(np.float32)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _capsules(joints, p_idx, c_idx, albedo, lights, K, H, W, ss, radius):
    dev, dt = joints.device, joints.dtype
    u = (torch.arange(W * ss, device=dev, dtype=dt) + 0.5) / ss - 0.5
    v = (torch.arange(H * ss, device=dev, dtype=dt) + 0.5) / ss - 0.5
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack([(uu - K[0, 2] + 0.5) / K[0, 0],
                     (vv - K[1, 2] + 0.5) / K[1, 1],
                     torch.ones_like(uu)], dim=-1).reshape(-1, 3)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    p0, p1 = joints[p_idx], joints[c_idx]
    r2 = float(np.float32(radius) ** 2)
    ba, oa = p1 - p0, -p0
    baba, baoa, oaoa = _dot(ba, ba), _dot(ba, oa), _dot(oa, oa)
    dr = d[:, None, :]
    bard, rdoa = _dot(dr, ba), _dot(dr, oa)
    a = baba - bard ** 2
    b = baba * rdoa - baoa * bard
    c = baba * oaoa - baoa ** 2 - r2 * baba
    h = b * b - a * c
    a = a.clamp_min(1e-12)
    t_cyl = (-b - torch.sqrt(h.clamp_min(0.0))) / a
    y = baoa + t_cyl * bard
    cyl_ok = (h > 0) & (y > 0) & (y < baba) & (t_cyl > 0)
    t = torch.where(cyl_ok, t_cyl, torch.full_like(t_cyl, float("inf")))
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


@torch.no_grad()
def capsule_frames(body, smpl_params: dict, K: np.ndarray, H: int, W: int,
                   *, seed: int, radius: float = 0.07, ss: int = 3,
                   device) -> tuple[np.ndarray, np.ndarray]:
    """The posed ``body`` (a reference ``SMPLModel``) traced as capsules
    in every frame of ``smpl_params`` (betas (1, 10), body_pose (F, 69),
    global_orient (F, 3), transl (F, 3)): images (F, H, W, 3) in 8-bit
    steps, as a PNG round trip leaves them, and coverage masks (F, H, W),
    float32 numpy arrays. Albedos come from ``seed``."""
    from .reference.plain.body import smpl_forward
    parents = np.asarray(body.parents)
    bones = np.arange(1, len(parents))
    g = np.random.default_rng(seed)
    albedo = torch.as_tensor(g.random((len(parents), 3)) * 0.6 + 0.35,
                             dtype=torch.float32, device=device)
    light = np.array([0.35, -0.5, 0.79])
    light /= np.linalg.norm(light)
    n = smpl_params["body_pose"].shape[0]

    def rows(k):
        v = np.asarray(smpl_params[k], np.float32)
        return torch.as_tensor(np.array(np.broadcast_to(v, (n, v.shape[-1]))),
                               device=device)
    out = smpl_forward(body, *(rows(k) for k in ("betas", "body_pose",
                                                 "global_orient", "transl")))
    light_t = torch.as_tensor(light, dtype=torch.float32, device=device)
    Kt = torch.as_tensor(K, dtype=torch.float32, device=device)
    p_idx = torch.as_tensor(parents[bones], device=device)
    c_idx = torch.as_tensor(bones, device=device)
    imgs = torch.empty((n, H, W, 3), device=device)
    msks = torch.empty((n, H, W), device=device)
    for i in range(n):
        lights = out.A[i, p_idx, :3, :3] @ light_t
        img, msk = _capsules(out.joints[i], p_idx, c_idx, albedo, lights, Kt,
                             H, W, ss, radius)
        imgs[i] = torch.floor(img * 255.0) / 255.0
        msks[i] = msk
    return imgs.cpu().numpy(), msks.cpu().numpy()


def yaw(angle: float) -> np.ndarray:
    """The axis-angle of a turn by ``angle`` about +y, in (-pi, pi]."""
    a = math.remainder(angle, 2 * math.pi)
    return np.array([0.0, a, 0.0], np.float32)
