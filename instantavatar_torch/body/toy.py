"""Deterministic synthetic body model for tests, benches and the smoke run.

Same numpy construction as ``instantavatar_tpu/body/toy.py`` (the real
SMPL pkls are license-gated): rings of vertices on the real SMPL kinematic
tree, distance-softmax skinning weights, small seeded blendshapes and,
with ``bone_rings``, extra rings along each bone rigidly skinned to the
parent joint. Only the final conversion differs: tensors on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from .smpl import SMPLModel

__all__ = ["toy_smpl_model", "toy_smpl_arrays", "write_toy_smpl_npz",
           "SMPL_PARENTS", "TOY_JOINTS"]

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12,
     13, 14, 16, 17, 18, 19, 20, 21], dtype=np.int64)

# approximate rest-pose joint locations, meters, y-up
TOY_JOINTS = np.array([
    [0.00, 0.00, 0.00], [0.09, -0.07, 0.00], [-0.09, -0.07, 0.00],
    [0.00, 0.11, 0.00], [0.10, -0.45, 0.00], [-0.10, -0.45, 0.00],
    [0.00, 0.24, 0.00], [0.10, -0.84, -0.02], [-0.10, -0.84, -0.02],
    [0.00, 0.30, 0.00], [0.12, -0.90, 0.10], [-0.12, -0.90, 0.10],
    [0.00, 0.47, 0.00], [0.07, 0.40, 0.00], [-0.07, 0.40, 0.00],
    [0.00, 0.58, 0.02], [0.17, 0.42, 0.00], [-0.17, 0.42, 0.00],
    [0.43, 0.41, 0.00], [-0.43, 0.41, 0.00], [0.68, 0.40, 0.00],
    [-0.68, 0.40, 0.00], [0.76, 0.40, 0.00], [-0.76, 0.40, 0.00],
], dtype=np.float32)


def toy_smpl_arrays(ring_size: int = 8, num_betas: int = 10, seed: int = 0,
                    bone_rings: int = 0) -> dict[str, np.ndarray]:
    """The toy model as numpy arrays (SMPLModel field names)."""
    rng = np.random.RandomState(seed)
    J = 24
    joints = TOY_JOINTS.copy()
    parents = SMPL_PARENTS

    angles = 2 * np.pi * np.arange(ring_size) / ring_size
    verts = []
    for j in range(J):
        u = np.array([np.cos(0.7 * j), np.sin(0.9 * j), np.cos(1.3 * j + 1)])
        u /= np.linalg.norm(u)
        w = np.array([-u[1], u[0], 0.0])
        if np.linalg.norm(w) < 1e-3:
            w = np.array([1.0, 0.0, 0.0])
        w /= np.linalg.norm(w)
        v2 = np.cross(u, w)
        ring = (joints[j][None]
                + 0.05 * np.cos(angles)[:, None] * w[None]
                + 0.05 * np.sin(angles)[:, None] * v2[None])
        verts.append(ring)
    v_template = np.concatenate(verts, axis=0).astype(np.float32)
    V = v_template.shape[0]

    J_regressor = np.zeros((J, V), dtype=np.float32)
    for j in range(J):
        J_regressor[j, j * ring_size:(j + 1) * ring_size] = 1.0 / ring_size

    d = np.linalg.norm(v_template[:, None] - joints[None], axis=-1)
    logits = -d / 0.02
    logits -= logits.max(axis=1, keepdims=True)
    w = np.exp(logits)
    weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    shapedirs = (0.01 * rng.randn(V, 3, num_betas)).astype(np.float32)
    posedirs = (0.001 * rng.randn((J - 1) * 9, V * 3)).astype(np.float32)

    if bone_rings > 0:
        extra_v, extra_w = [], []
        for b in range(1, J):
            p = int(parents[b])
            axis = joints[b] - joints[p]
            an = axis / max(np.linalg.norm(axis), 1e-9)
            w0 = np.array([-an[1], an[0], 0.0])
            if np.linalg.norm(w0) < 1e-3:
                w0 = np.array([1.0, 0.0, 0.0])
            w0 /= np.linalg.norm(w0)
            v2 = np.cross(an, w0)
            for k in range(1, bone_rings + 1):
                f = k / (bone_rings + 1.0)
                center = joints[p] * (1 - f) + joints[b] * f
                ring = (center[None]
                        + 0.05 * np.cos(angles)[:, None] * w0[None]
                        + 0.05 * np.sin(angles)[:, None] * v2[None])
                extra_v.append(ring)
                w_row = np.zeros((ring_size, J), np.float32)
                w_row[:, p] = 1.0
                extra_w.append(w_row)
        ev = np.concatenate(extra_v, axis=0).astype(np.float32)
        ew = np.concatenate(extra_w, axis=0)
        Ve = ev.shape[0]
        v_template = np.concatenate([v_template, ev], axis=0)
        weights = np.concatenate([weights, ew], axis=0)
        J_regressor = np.concatenate(
            [J_regressor, np.zeros((J, Ve), np.float32)], axis=1)
        shapedirs = np.concatenate(
            [shapedirs, (0.01 * rng.randn(Ve, 3, num_betas))
             .astype(np.float32)], axis=0)
        pd = posedirs.reshape((J - 1) * 9, V, 3)
        pd_e = (0.001 * rng.randn((J - 1) * 9, Ve, 3)).astype(np.float32)
        posedirs = np.concatenate([pd, pd_e], axis=1) \
            .reshape((J - 1) * 9, (V + Ve) * 3)

    faces = []
    for j in range(J):
        base = j * ring_size
        for k in range(ring_size - 2):
            faces.append([base, base + k + 1, base + k + 2])

    return dict(v_template=v_template, shapedirs=shapedirs,
                posedirs=posedirs, J_regressor=J_regressor,
                lbs_weights=weights, parents=parents,
                faces=np.asarray(faces, dtype=np.int64))


def toy_smpl_model(ring_size: int = 8, num_betas: int = 10, seed: int = 0,
                   bone_rings: int = 0, *,
                   device: torch.device | str) -> SMPLModel:
    """Build the toy model on ``device``. V = 24 * ring_size
    (+ 23 * bone_rings * ring_size) verts."""
    a = toy_smpl_arrays(ring_size, num_betas, seed, bone_rings)
    t = {k: torch.as_tensor(a[k], device=device)
         for k in ("v_template", "shapedirs", "posedirs", "J_regressor",
                   "lbs_weights")}
    return SMPLModel(parents=a["parents"], faces=a["faces"], **t)


def write_toy_smpl_npz(path, ring_size: int = 8, num_betas: int = 10,
                       seed: int = 0, bone_rings: int = 0):
    """Write the toy model as an SMPL release ``.npz`` (the keys of the
    official files that ``load_smpl_model`` reads), so that the entry
    points that take a model path load it; returns ``path``."""
    a = toy_smpl_arrays(ring_size, num_betas, seed, bone_rings)
    kintree = np.stack([a["parents"], np.arange(len(a["parents"]))])
    np.savez(path, v_template=a["v_template"], shapedirs=a["shapedirs"],
             posedirs=a["posedirs"], J_regressor=a["J_regressor"],
             weights=a["lbs_weights"], kintree_table=kintree, f=a["faces"])
    return path
