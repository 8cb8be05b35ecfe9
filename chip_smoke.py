"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives ``instantavatar_torch``'s flagship novel-view render (toy body,
Fast-SNARF res 128, voxel+triplane field at full width, flat-stream
render at 540x540, the bench.py configuration with random numpy-seeded
weights) and its training (the same configuration as
``tools/quality_bench.py:make_flagship(reduced=True)``) through the entry
points a user calls, and checks it in phases:

  1. device: a CUDA card is required (no CPU run); TF32 is switched off;
  2. build: the fused field-head, hash-encode and nearest-vertex kernels
     are compiled from csrc/ with nvcc, one nvcc per source, all started
     together;
  3. kernel vs its plain PyTorch version at M = 1, 17, 1000, one pass of
     the persistent grid +- 1 and 1,000,003 rows; the kernel, the plain
     version and the library yardstick (five bf16 cuBLAS GEMMs, see
     ``cublas_chain``) timed in turns with CUDA events at 1.5M rows,
     beside the kernel's bound (``head_cost`` at 3.35 TB/s and 989
     TFLOP/s);
  4. the 540 px slice: 2 warm frames, then an 8-frame turntable through
     ``render_frames`` (each frame a replay of a captured CUDA graph at
     the session's learned budgets, ``train/frame_graph.py``); the
     kernel's launch counter must rise;
  5. head swap: one frame again with the plain head, PSNR-bounded;
  6. golden: the committed JAX golden frame (96 px), PSNR-bounded;
  7. training: a 264 px capsule scene (30 train + 2 val frames, made on
     the card), 150 ``AvatarModel.step`` calls (5 epochs; grid update and
     occupancy regularizer every 20 steps, cached-search steps between,
     Adam with the 20-epoch decay), each one replay of the step's
     captured CUDA graph (``train/step_graph.py``); step times, peak
     memory, occupied cells, the graphs captured and their capture time,
     the loss fall (bounded);
  8. validation: the 2 val frames rendered with ``eval_grid="density"``
     (``build_test_grid``, then the flat render through the kernel),
     PSNR-bounded against the GT; then validate, one training step,
     validate: the frame graphs capture nothing anew (they read the
     parameters at their addresses) and each frame equals the eager one;
  9. training golden: one JAX update step and one plain step
     (``tests/data/torch_train_golden.npz``) replayed on the card: losses,
     gradients and the updated grid within the CPU tests' tolerances;
 10. at the rows per launch of each path (turntable, training, val
     render, the paths of phases 11 and 13 and each eval mode of phase
     14), read from the ``rows`` counter: the kernel against its plain
     version (as in phase 3) and timed;
 11. the entry points: a 264 px capsule sequence directory (20 train + 1
     val + 2 test frames, toy body) written by the port's writer, then
     ``instantavatar_torch.cli.train`` in process with the flagship conf
     (``network=voxel_triplane``, the rest at conf defaults; the Trainer
     trains 4 steps per ``train_multi_step`` call on captured graphs, as
     every CLI's Trainer in phases 11-15 does) for 5 epochs,
     a rerun that must resume and take no step (its validation render is
     the val path), ``Trainer.test``, ``animate`` on a 6-pose sequence
     and ``novel_view`` on 8 frames, both at 540 px; the files each
     writes, finite frames, alpha coverage, val PSNR above an all-white
     frame's; ms/step, val/test PSNR and SSIM, ms/frame per CLI;
 12. the confs' default network (``NGPField``, 16 x 2 @ 2^19 hash grid,
     fp32 head) through the entry points on phase 11's sequence with no
     network override: ``train`` for 5 epochs (ms/step, batch ms, peak
     memory, val PSNR above an all-white frame's), ``eval`` with
     ``SNARF_NGP_refine`` (20 epochs over the 2 test frames; the field
     bit-identical to the train checkpoint, the SMPL parameters moved;
     test PSNR/SSIM from ``results.txt``), ``fit`` with
     ``SNARF_NGP_fitting`` (``w_lpips=0``, 2 epochs) on a copy of the
     sequence (every frame exported to ``poses/train.npz``, finite losses,
     the depth term logged), ``animate`` at 540 px, each run launching
     the hash-encode kernel (``csrc/hash_encode.cu``, counted per path);
     then the kernel against its plain version (``hash_encode_ref``,
     ``hash_encode_backward_ref``) at ENCODE_CHECK_N points with boundary,
     lattice and out-of-range rows (features ENCODE_FEAT_TOL, gradients
     ENCODE_GRAD_RTOL) and at ENCODE_GRID_N points on ``encode_grids``
     (F = 1, 4, 8 and 3 features per row, 40 levels), its deterministic
     backward bit-identical on two runs at 2^20 points and on each grid;
     on the largest call of a training step and of an animate frame, the
     kernel held against its plain version on those points (same
     tolerances), then both timed in turns, forward, forward plus the
     table's backward (the deterministic backward too), forward plus both
     gradients (fit's and refine's call) and the points' backward alone,
     with their device launches per call and the byte bound, and the
     kernel by level group (``encode_groups``: each group of the forward's
     levels alone on a view of the table, beside that group's bound); and
     the committed JAX NGP golden
     frame (48 px), PSNR-bounded;
 13. the in-the-wild demo (``bash/run-neuman-demo.sh``) on a copy of phase
     11's sequence read as ``dataset=custom/video``, made to look like a
     preprocessed video first (the toy body written as
     ``SMPL_NEUTRAL.npz``, ROMP-like ``thetas`` poses perturbed from the
     ground truth by REFINE_SIGMA, keypoints projected from it) and run
     through ``python -m instantavatar_torch.preprocess.process_sequence``
     as a subprocess on the card (only refine with ``--silhouette`` and
     the overlay may run; refine ms per iteration of each stage, keypoint
     and transl errors before and after, the transl error at most half,
     ``body_pose[:, 60:]`` zero, an overlay per frame); then ``fit`` with
     ``SNARF_NGP_fitting deformer=smpl`` at the conf's defaults (LPIPS with
     the random VGG trunk, the depth term, SMPL lr 1e-4; every frame
     exported, both patch terms finite, starting from
     ``poses_optimized.npz``, the SMPL parameters moved),
     ``train --config-name demo sampler.dilate=8`` on the fitted poses
     (the fit and the train each launching the hash-encode kernel)
     (per-frame smpl_init grids (F, 64, 64, 64), each partly occupied,
     the seeded stack held by the 500-step latch, val PSNR above an
     all-white frame's; ms/step, peak memory), ``novel_view`` and
     ``animate`` at 540 px and ``animate`` at 67 px (the 1-pixel-block
     render); ``nearest_vertex`` (against the 192-vertex toy body and a
     7,008-vertex one; the kernel, held bit-equal to the plain version,
     and the plain version), ``nearest_warp`` at a fit step's own warp
     call (``fit_step_model``: the demo fit's conf on the 7,008-vertex
     body at 540 px; the kernels in turns with the plain version and
     with ``index_select``, forward and with the backward, the share of
     runs merged in a warp) and the LPIPS VGG
     trunk (plain PyTorch) timed beside their bounds with their device
     launches per call (XLA in the JAX package: not TPU kernels); the
     committed JAX SMPL-deformer golden
     frame (48 px), PSNR-bounded; one 540 px SMPL-deformer frame with the
     voxel-triplane field, which must launch the fused head; then the
     full-width refine: ``refine`` at the script's defaults (200 + 100
     iterations) on REFINE_FRAMES frames (the custom conf's train range)
     of the 7,008-vertex toy body (all 25 BODY25 slots) against
     REFINE_SIZE px capsule masks traced on the card: ms per iteration of
     each stage, peak memory, the errors before and after (the transl
     error at most half);
 14. the rest of the single-device package: the native data engine (phase
     11's train split must run on it; one more epoch of the train CLI
     with ``+dataset.opt.native=false`` for the Python path's numbers; a
     train batch timed warm on both paths; the engine's decode of the
     sequence), a ``MocapDataset`` train split (its default EdgeSampler)
     feeding 20 ``AvatarModel.step`` calls of the flagship configuration
     (finite, falling losses), ``train network=triplane`` (three 32 x
     256^2 planes) for 2 epochs (ms/step, peak memory, val PSNR above an
     all-white frame's), and one 540 px frame of phase 4's avatar in each
     eval mode of ``EVAL_MODES`` (flat, windows, dense, uncached, the
     probed dense march, shared-corner, tiled rows, no transmittance cut,
     the alpha skip), each frame on graphs (the ray-bundle modes too):
     warm ms/frame, head launches and rows (each must
     launch the head), rgb PSNR against the flat and the dense frame and,
     as in phase 5, against the mode's frame with the plain head
     (PSNR-bounded);
 15. the parallel layer (``instantavatar_torch.parallel``) on the one
     card: 21 DP training steps of phase 7's configuration (the first a
     grid update) on 2 ranks over gloo sharing the card, eagerly (a gloo
     group cannot be captured; parameters bit-identical on both
     afterwards; step 1's losses within 1e-4 of the single-process step
     on the whole batch fed the ranks' draws, its grid exactly); ms/step
     and the bytes reduced (the one-NCCL-rank run is phase 18's); phase
     4's 540 px
     turntable of 3 on 2 gloo ranks in the stride and band layouts
     (each rank launching the head, the bake memo engaged, PSNR-bounded
     against the single-device frames) and the gather of a frame's bands
     timed; one band's program alone for R = 2, 4, 8 (stride) and 4
     (band) beside the replicated bake; ``train_multi`` with two copies
     of phase 11's sequence for 2 epochs (on graphs, its default on
     CUDA), each subject's checkpoint through ``animate``. Spawned ranks
     report their head launches and rows through files;
 16. the captured step against the eager one, at full width, for the
     flagship (phase 7's), the NGP conf default (phase 12's) and the
     demo's fit (SMPL deformer, LPIPS, SMPL optimization) and train
     (smpl_init) steps (phase 13's): 20 steps eager, then 20 through
     ``train_multi_step`` in groups of 4 on graphs, from one state and one
     seed, bit-equal under PyTorch's deterministic algorithms (where a
     capture refuses that mode: the default mode, no further apart than
     two eager runs; the mode is printed; the NGP and demo graph runs
     must launch the hash-encode kernel); then, per mode and step kind
     (grid update, plain), warm ms/step, one profiled step's device
     kernels, busy share and host launch calls, peak memory, the
     hash-encode kernels' ms and the four kernels with the most ms in
     that step, and the graphs captured with their capture time; the NGP
     plain step beside its times with the plain PyTorch encode;
 17. the flat frame as JAX's one program: phase 4's avatar at 540 px, the
     8-frame turntable and a 6-pose ``animate`` sequence (each pose's own
     grid and bake), first eager at exact counts (``render_stream``
     without budgets), then through ``render_frames`` at the session's
     learned sample and cell budgets, each frame one graph replay
     (bounded PSNR against the eager frame, max |diff| printed); warm
     ms/frame and rays/s, peak memory, one profiled frame's device
     kernels, busy share and host launch calls for both runs; the head's
     launches on the replays (none captured in the timed pass), the
     graphs captured and their capture time, the learned budgets against
     the counts; in the animate sequence's timed graph pass each frame's
     grid is one grid-graph replay and one nearest-vertex launch over its
     64^3 cells, in the turntable's none; a frame at priors too small for
     it must re-render (rebaking) to the same frame. Every flat frame of phases 4-16 runs
     the same budgeted, graphed frame. The animate sequence also runs
     with graph frames on eager grids (PR 11's form) beside the eager and
     the all-graph runs;
 18. JAX's last eager programs on graphs, each eager and then on graphs
     from one state and seed, bit-equal under deterministic algorithms,
     with warm ms, one profiled call's device kernels, busy share and
     host launch calls, peak memory and the graphs captured with their
     seconds: (18.1) the DP step on one spawned NCCL rank, phase 15's
     inputs (its ``all_reduce`` real and inside the graph; NCCL puts no
     two ranks on one card), steps 1 (grid update) and 2 (plain), the
     eager step also against the single-process step; (18.2)
     ``train_multi``'s combined step on two subjects of phase 7's
     configuration in one process, 4 combined steps (the CLI itself runs
     on graphs in phase 15); (18.3) the animate poses' grids
     (``build_pose_grid``, and ``build_test_grid`` on two), graph equal to
     eager exactly, ms per grid per mode;
 19. JAX's last jitted programs on graphs: phase 4's avatar at 540 px in
     each ray-bundle mode (windows, dense, the probed dense march,
     uncached), two frames of a session (bake, reuse) eager at the
     budgets and on graphs, bit-equal under deterministic algorithms (or
     FRAME_MIN_DB apart where a capture refuses that mode), each against
     the exact-count eager frame (``render_rays_frame``, PSNR floor
     FRAME_MIN_DB); then warm ms/frame, peak memory (a graph's capture
     included, at most 1.2x the exact eager frame's), one profiled
     frame's device kernels, busy share and host launch calls for the
     exact eager frame, the eager frame at the budgets and the graph
     frame, the captures with their seconds, the hit rays against the ray
     budget; a dense frame at priors too small for it (RAYS_TINY) must
     re-render on graphs, rebaking, to the exact frame; and
     ``make_dp_render`` on the frame's rays over DP_RENDER_SHARDS
     in-process shards, each shard one graph replay, held against eager
     the same way and timed.

Any failed check, a spawned rank's non-zero exit or a spawned run past
its time limit exits non-zero. The last stdout line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``
and the line before it lists the kernels: the hash encode with its
launches on each NGP path (phases 12, 13 and 16), its times at the
training call's points and its forward at the animate call's, and the
head with its launches in
each path (turntable, training, val render, phase 11's CLI train run,
Trainer validation, Trainer test, animate and novel_view, and phase 13's
SMPL-deformer voxel-triplane frame, phase 14's eval modes, phase
15's ranks and paths, phase 16's flagship graph run, phase 17's
frame graphs, phase 18's DP, multi-subject and test-grid graphs and
phase 19's ray-bundle and ``make_dp_render`` graphs; the
NGP and triplane paths evaluate the fp32 head and launch no head
kernel), and the nearest vertex with its launches in each path that
searches it (phase 11's animate and novel_view, phase 12's animate,
phase 13's fit, train (smpl_init), novel_view and animate runs and
SMPL-deformer frame, phase 17's timed graph passes; each counted from 0)
and its times at 64^3 cells against 7,008 vertices. A captured step's or
frame's launches are counted once per
replay, and the eager warm-up before each capture launches the kernels
once more. ``--profile DIR`` also
writes torch.profiler summaries and traces of two steady-state frames and
of one grid-update step plus three plain training steps to DIR.

Run from the repository root:  python3 chip_smoke.py [--profile DIR]
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H = W = 540
# Kernel vs plain. The tensor cores sum in another fp32 order than the
# plain version, so a hidden unit whose sum lies at a bf16 rounding tie may
# round the other way (the plain version's own fp32 sums miss a float64
# evaluation of the same rounding points the same way). Every row is held
# to HEAD_TOL except at most 1 in HEAD_FLIP_RATE rows, and those to
# HEAD_FLIP_TOL (one such flip moves an output by up to ~1e-2 at these
# widths); on inputs whose every fp32 sum is exact in any order
# (``head_inputs(exact=True)``) there are no ties and the bound is
# HEAD_EXACT_TOL everywhere.
HEAD_TOL = 2e-3
HEAD_FLIP_RATE = 2000
HEAD_FLIP_TOL = 2e-2
HEAD_EXACT_TOL = 1e-6
HEAD_SWAP_MIN_DB = 40.0
GOLDEN_MIN_DB = 35.0
TRAIN_SIZE, TRAIN_FRAMES, VAL_FRAMES, TRAIN_STEPS = 264, 30, 2, 150
# bounds set from the first card run (loss ratio 0.060, val 35.89 dB)
TRAIN_LOSS_FALL_MAX = 0.15   # mean mse_loss, last 10 steps / first 10
VAL_MIN_DB = 32.0
JAX_CACHED_EPOCH5_DB = 33.72   # artifacts/r5_warp_gate.jsonl (TPU history)
# phase 11: the sequence the entry points train on, and their runs
CLI_SIZE, CLI_TRAIN, CLI_VAL, CLI_TEST = 264, 20, 1, 2
CLI_EPOCHS, CLI_POSES, CLI_TURNTABLE = 5, 6, 8
# phase 12: the NGP golden's floor, fit's epochs
NGP_GOLDEN_MIN_DB, FIT_EPOCHS = 35.0, 2
# the hash-encode kernel against its plain version: features absolute
# (the same fp32 lerp, 8 products summed in another order), gradients
# L2-relative (fp32 atomics sum in another order); the point counts
# checked (2^19 is the plain version's chunk; 2^20 one training render
# call), the timed repetitions of a whole call and of one level group
ENCODE_FEAT_TOL, ENCODE_GRAD_RTOL = 1e-6, 1e-5
ENCODE_CHECK_N = (1, 17, 2 ** 19 - 1, 2 ** 19 + 1, 2 ** 20)
ENCODE_GRID_N = 2 ** 16 + 3    # points at each of the other grids
ENCODE_REPS, ENCODE_GROUP_REPS = 15, 5
# phase 4's (bench.py's) render knobs; phase 14 varies the eval mode
AVATAR_540_KW = dict(n_steps=128, k_cap=8, grid_size=64, eval_n_steps=48,
                     cache_n_cand=1, samples_per_ray=5.0,
                     eval_grid="smpl_shell", shell_margin=0.08)
# phase 14: the eval modes (JAX's AvatarModel knobs), each rendered on
# phase 4's avatar and state; the data and triplane runs' sizes
EVAL_MODES = {
    "flat": {},
    "windows": dict(eval_sampling="windows"),
    "dense": dict(eval_sampling="dense"),
    "uncached": dict(use_warp_cache=False),
    "cache_fused_probe": dict(eval_sampling="dense", cache_fused_probe=True),
    "shared_corner_eval": dict(shared_corner_eval=True),
    "flat_tile_rows": dict(flat_tile_rows=True),
    "term_T_none": dict(term_T=None),
    "alpha_skip": dict(alpha_skip=0.01),
}
# PSNR floors (dB) of each mode's frame against the flat and the dense
# frame, set from the first card run (PERF.md): 25 where the modes
# sample different z (JAX's windows/flat-vs-uncached bar,
# tests/test_e2e_slice.py), 30 for the cached dense march against the full
# search (JAX's cached-vs-uncached bar), 60 where the samples are the same
# and only fp32 order differs, 45 for the samples past the transmittance
# cut, 33 for the shared-corner lerp's extrapolation
MODE_MIN_DB = {
    "flat": (None, 25.0),
    "windows": (25.0, 25.0),
    "dense": (25.0, None),
    "uncached": (25.0, 30.0),
    "cache_fused_probe": (25.0, 60.0),
    "shared_corner_eval": (33.0, 25.0),
    "flat_tile_rows": (60.0, 25.0),
    "term_T_none": (45.0, 25.0),
    "alpha_skip": (60.0, 25.0),
}
MOCAP_STEPS, TRIPLANE_EPOCHS = 20, 2
# phase 13's preprocessing: the ROMP-like start (sigma in m for transl, in
# rad for global_orient and body_pose) and its seed, the subprocess's time
# limit; the full-width refine: confs/dataset/custom/video.yaml's train
# frames (0-199) at 540 px on the 7,008-vertex toy body (SMPL: 6,890)
REFINE_SIGMA, REFINE_SEED, PREPROCESS_TIMEOUT = 0.05, 13, 600.0
REFINE_FRAMES, REFINE_SIZE = 200, 540
REFINE_ITERS, REFINE_SIL_ITERS = 200, 100   # the script's defaults
# phase 4's avatar (bench.py's configuration), which phases 14 and 15 reuse
SLICE_AVATAR_ARGS = dict(deformer_res=128, grid_size=64, voxel_res=64,
                         plane_res=256, param_seed=0, sigma_bias=100.0,
                         shell_margin=0.08)
# phase 15: ranks sharing the card, DP training steps (grid updates at
# steps 0 and 20, the first step cold) and their draws' seed, the loss
# bound against the single-process step, the DP frame's
# PSNR floor against the single-device frame, the turntable, the band
# programs timed alone, train_multi's subjects and epochs, and the
# spawned runs' time limit
DP_RANKS, DP_STEPS, DP_SEED, DP_LOSS_RTOL, DP_MIN_DB = 2, 21, 1000, 1e-4, 40.0
DP_TURNTABLE = 3
DP_BAND_LAYOUTS = (("stride", 2), ("stride", 4), ("stride", 8), ("band", 4))
MULTI_SUBJECTS, MULTI_EPOCHS = ("a", "b"), 2
SPAWN_TIMEOUT = 300.0
# phase 16: steps run eager and on graphs from one state, the Trainer's
# group size, the generator seed, the warm steps timed per kind
GRAPH_STEPS, GRAPH_GROUP, GRAPH_SEED, GRAPH_TIMED = 20, 4, 16, 5
# phase 18: train_multi's combined steps run eager and on graphs
MULTI_GRAPH_STEPS = 4
# phase 17: the animate poses, the untimed passes before a timed one, the
# graph frame's PSNR floor against the exact-count eager frame, and the
# priors that force an overflow (samples per block, cells)
FRAME_POSES, FRAME_WARM, FRAME_MIN_DB, FRAME_TINY = 6, 2, 60.0, (0.05, 1024)
# phase 19: the ray-bundle modes held and timed on graphs, the priors that
# force a dense frame's overflow (the rays' share, cells), make_dp_render's
# in-process ray shards and its timed calls
RAY_MODES = ("windows", "dense", "cache_fused_probe", "uncached")
RAYS_TINY, DP_RENDER_SHARDS, DP_RENDER_TIMED = (0.01, 1024), 4, 3
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor-core peak, same source
FP32_FLOP_PER_S = 67e12        # fp32 outside the tensor cores, same source


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return math.inf if mse == 0 else 10 * math.log10(1.0 / mse)


def cuda_ms(fn, reps: int) -> list[float]:
    """Device time of ``fn``, once per rep: CUDA events around it, queued
    behind a ~1 ms device sleep so that the host's launch overhead is
    hidden and not counted."""
    out = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def head_inputs(M: int, seed: int, device, exact: bool = False):
    """Flagship-width head (E=56) with numpy-seeded weights: He-scaled
    normal weights, 0.1 * N(0, 1) biases, N(0, 1) rows; or, with
    ``exact``, the same scales on a coarse grid (rows k/8, |k| <= 8;
    weights k/8, |k| <= 3; biases k/64), on which every product and
    partial sum of every layer is a multiple of 2^-18 far below 2^6, so
    exact in fp32 whatever the summation order."""
    g = np.random.default_rng(seed)
    dims = [(56, 64), (64, 16), (15, 64), (64, 64), (64, 3)]

    def t(a, dt):
        return torch.as_tensor(a.astype(np.float32), device=device).to(dt)
    if exact:
        ws = [t(g.integers(-3, 4, d) / 8, torch.bfloat16) for d in dims]
        bs = [t(g.integers(-4, 5, d[1]) / 64, torch.float32) for d in dims]
        enc = t(g.integers(-8, 9, (M, 56)) / 8, torch.bfloat16)
    else:
        ws = [t(g.standard_normal(d) * np.sqrt(2 / d[0]), torch.bfloat16)
              for d in dims]
        bs = [t(0.1 * g.standard_normal(d[1]), torch.float32) for d in dims]
        enc = t(g.standard_normal((M, 56)), torch.bfloat16)
    return enc, ws[:2], bs[:2], ws[2:], bs[2:]


def head_float64(enc, sigma_w, sigma_b, color_w, color_b):
    """The head's rounding points (bf16 operands and hidden activations)
    with the sums taken in float64, exactly. On
    ``head_inputs(exact=True)`` the plain version must reproduce it,
    which shows that those inputs hold no rounding tie."""
    (w0, w1), (b0, b1) = sigma_w, sigma_b
    (cw0, cw1, cw2), (cb0, cb1, cb2) = color_w, color_b

    def bf(x):
        return x.to(torch.bfloat16).double()
    h = bf(torch.relu(enc.double() @ w0.double() + b0.double()))
    geo = h @ w1.double() + b1.double()
    c = bf(torch.relu(bf(geo[:, 1:]) @ cw0.double() + cb0.double()))
    c = bf(torch.relu(c @ cw1.double() + cb1.double()))
    return torch.sigmoid(c @ cw2.double() + cb2.double()), geo[:, 0]


def head_gap(out, ref) -> tuple[float, int]:
    """Per-row max |difference| over colour and sigma between two head
    results: (its max over rows, the rows past HEAD_TOL)."""
    d = torch.maximum((out[0].double() - ref[0].double()).abs().amax(1),
                      (out[1].double() - ref[1].double()).abs())
    return float(d.max()), int((d > HEAD_TOL).sum())


def head_agrees(out, ref) -> bool:
    """The kernel-vs-plain rule stated at HEAD_TOL."""
    worst, n_over = head_gap(out, ref)
    return (worst <= HEAD_FLIP_TOL
            and n_over <= out[1].shape[0] // HEAD_FLIP_RATE)


def cublas_chain(enc, sigma_w, sigma_b, color_w, color_b):
    """The head as PyTorch's library calls: five bf16 cuBLAS GEMMs
    (``torch.addmm``, bf16 biases) with the ReLUs and the sigmoid between
    them, the (M, 64) intermediates through device memory. The library
    yardstick (``library_ms``) only; the port never calls it."""
    (w0, w1), (b0, b1) = sigma_w, sigma_b
    (cw0, cw1, cw2), (cb0, cb1, cb2) = color_w, color_b
    h = torch.addmm(b0, enc, w0).relu_()
    geo = torch.addmm(b1, h, w1)
    c = torch.addmm(cb0, geo[:, 1:], cw0).relu_()
    c = torch.addmm(cb1, c, cw1).relu_()
    return torch.sigmoid(torch.addmm(cb2, c, cw2).float()), geo[:, 0].float()


def head_bound(M: int) -> tuple[float, str]:
    """Least time (ms) the card could take for the head on M rows, and
    what sets it: bytes at the HBM rate or FLOPs at the bf16 peak."""
    from instantavatar_torch.kernels import head_cost
    flops, nbytes = head_cost(M, 56)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


@torch.no_grad()
def head_check(dev, M: int, seed: int, what: str = "") -> float:
    """The kernel against its plain version on M rows: on exact-sum inputs
    (which must hold no tie) to HEAD_EXACT_TOL, on normal inputs by
    ``head_agrees``. Prints the gaps; returns the normal inputs' max|diff|."""
    from instantavatar_torch.kernels import (fused_field_head,
                                             fused_field_head_ref)
    args = head_inputs(M, seed, dev, exact=True)
    out, ref = fused_field_head(*args), fused_field_head_ref(*args)
    check(head_gap(ref, head_float64(*args))[0] <= HEAD_EXACT_TOL,
          f"the exact inputs are not tie-free at M={M}")
    ex = head_gap(out, ref)[0]
    args = head_inputs(M, seed, dev)
    out, ref = fused_field_head(*args), fused_field_head_ref(*args)
    worst, n_over = head_gap(out, ref)
    plain_worst, plain_over = head_gap(ref, head_float64(*args))
    print(f"[kernel] {what}M={M}: exact-sum inputs max|diff| {ex:.3e} "
          f"(tol {HEAD_EXACT_TOL}); normal inputs max|diff| {worst:.3e}, "
          f"rows past {HEAD_TOL}: {n_over} (allowed {M // HEAD_FLIP_RATE}, "
          f"each <= {HEAD_FLIP_TOL}); the plain version vs float64: "
          f"{plain_worst:.3e}, {plain_over} rows")
    check(ex <= HEAD_EXACT_TOL and head_agrees(out, ref),
          f"kernel disagrees with plain version at M={M}")
    return worst


def kernel_phase(dev) -> dict:
    """Phase 3: the kernel against its plain version at the tile edges and
    at full size, then timed in turns with the plain version and the
    cuBLAS chain at 1.5M rows. Returns the measured numbers."""
    from instantavatar_torch.kernels import (fused_field_head,
                                             fused_field_head_ref, head_cost,
                                             head_wave_rows)
    wave = head_wave_rows(dev)
    print(f"[kernel] one pass of the persistent grid covers {wave} rows")
    max_err = max(head_check(dev, M, M)
                  for M in (1, 17, 1000, wave - 1, wave + 1, 1_000_003))
    with torch.no_grad():
        M = 1_500_000
        args = head_inputs(M, 7, dev)
        enc, sw, sb, cw, cb = args
        lib_args = (enc, sw, [b.bfloat16() for b in sb], cw,
                    [b.bfloat16() for b in cb])
        lc, ls = cublas_chain(*lib_args)
        rc, rs = fused_field_head_ref(*args)
        lib_err = head_gap((lc, ls), (rc, rs))[0]
        fns = {"kernel": lambda: fused_field_head(*args),
               "plain": lambda: fused_field_head_ref(*args),
               "library": lambda: cublas_chain(*lib_args)}
        for _ in range(3):
            for fn in fns.values():
                fn()
        ms = {k: [] for k in fns}
        for _ in range(15):
            for k, fn in fns.items():
                ms[k] += cuda_ms(fn, 1)
    res = {k + "_ms": statistics.median(v) for k, v in ms.items()}
    res["bound_ms"], res["bound_by"] = head_bound(M)
    res["max_err"] = max_err
    share = res["bound_ms"] / res["kernel_ms"]
    flops, nbytes = head_cost(M, 56)
    secs = res["kernel_ms"] * 1e-3
    print(f"[kernel] M={M}: kernel {res['kernel_ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, cuBLAS chain {res['library_ms']:.4f} "
          f"ms (median of 15 each, in turns, CUDA events); kernel "
          f"{flops / secs / 1e12:.2f} TFLOP/s, {nbytes / secs / 1e9:.0f} "
          f"GB/s")
    print(f"[kernel] bound {res['bound_ms']:.4f} ms (set by "
          f"{res['bound_by']}), kernel at {100 * share:.1f}% of it; kernel "
          f"{res['library_ms'] / res['kernel_ms']:.2f}x faster than the "
          f"cuBLAS chain (whose bf16 biases and outputs put it "
          f"{lib_err:.2e} from the plain version)")
    return res


def path_timings(dev, rows_per_launch: dict) -> tuple[dict, float]:
    """Phase 10: at each path's rows per launch, the kernel against its
    plain version (``head_check``) and timed. Returns the times and the
    largest max|diff|."""
    from instantavatar_torch.kernels import fused_field_head
    out, max_err = {}, 0.0
    with torch.no_grad():
        for path, rows in rows_per_launch.items():
            M = max(1, round(rows))
            max_err = max(max_err, head_check(dev, M, 11, f"{path}: "))
            args = head_inputs(M, 11, dev)
            for _ in range(3):
                fused_field_head(*args)
            out[path] = statistics.median(cuda_ms(
                lambda: fused_field_head(*args), 15))
            bound, _ = head_bound(M)
            print(f"[kernel] {path}: {M} rows per launch, kernel "
                  f"{out[path]:.4f} ms (median of 15), bound {bound:.4f} "
                  f"ms, {100 * bound / out[path]:.1f}% of it")
    return out, max_err


def make_avatar(device, *, deformer_res, grid_size, voxel_res, plane_res,
                param_seed, sigma_bias, shell_margin):
    from instantavatar_torch import convert
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SNARFDeformer
    from instantavatar_torch.models import VoxelTriplaneField
    from instantavatar_torch.train import AvatarModel
    body = toy_smpl_model(bone_rings=3, device=device)
    field = VoxelTriplaneField(voxel_res=voxel_res, plane_res=plane_res,
                               device=device)
    field.load_state_dict(convert.field_params_from_numpy(
        convert.seeded_field_params(voxel_res, plane_res, param_seed,
                                    sigma_bias=sigma_bias)))
    deformer = SNARFDeformer(body, resolution=deformer_res,
                             cano_pose="a_pose", n_iters=6, cand_cap=2,
                             n_init_active=4)
    return AvatarModel(body, field, deformer, **{
        **AVATAR_540_KW, "grid_size": grid_size,
        "shell_margin": shell_margin})


def profile(fn, profile_dir: Path, name: str, what: str) -> None:
    """Run ``fn`` under torch.profiler; write the kernel table and trace
    to ``profile_dir`` and print the device busy share."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    profile_dir.mkdir(parents=True, exist_ok=True)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avg = prof.key_averages()
    dkey = ("device_time_total" if hasattr(avg[0], "device_time_total")
            else "cuda_time_total")
    # device kernels only (operator rows repeat their kernels' time)
    busy_us = sum(getattr(e, "self_" + dkey) for e in avg
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    table = avg.table(sort_by="self_" + dkey, row_limit=40)
    (profile_dir / f"{name}.txt").write_text(table)
    prof.export_chrome_trace(str(profile_dir / f"{name}_trace.json"))
    print(f"[profile] {what}: wall {wall_us / 1e3:.2f} ms (profiled), "
          f"device busy {busy_us / 1e3:.2f} ms, busy share "
          f"{busy_us / wall_us:.3f}")
    print("[profile] " + "\n[profile] ".join(table.splitlines()[:30]))


def make_trainer(device, *, deformer_res=128, grid_size=64, voxel_res=64,
                 plane_res=256, steps_per_epoch=TRAIN_FRAMES):
    """``tools/quality_bench.py:make_flagship(reduced=True)`` in the port,
    with the 20-epoch schedule of tools/warp_cache_gate.py."""
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SNARFDeformer
    from instantavatar_torch.models import VoxelTriplaneField
    from instantavatar_torch.train import AvatarModel, make_optimizer
    body = toy_smpl_model(bone_rings=2, device=device)
    field = VoxelTriplaneField(voxel_res=voxel_res, plane_res=plane_res,
                               device=device)
    deformer = SNARFDeformer(body, resolution=deformer_res,
                             cano_pose="a_pose", n_iters=6, cand_cap=2,
                             n_init_active=4)
    return AvatarModel(body, field, deformer, n_steps=128, k_cap=48,
                       grid_size=grid_size, eval_n_steps=48, cache_n_cand=1,
                       samples_per_ray=5.0, noise_steps=500,
                       optimizer=make_optimizer(
                           1e-2, max_epochs=20,
                           steps_per_epoch=steps_per_epoch))


def capsule_splits(device, size: int, n_train: int, n_val: int):
    """Phase 7's capsule scene (made on ``device``) and its train split (4
    x 32^2 patches, seeded sampler and backgrounds) and val split."""
    from instantavatar_torch.data import (FrameDataset, PatchSampler,
                                          make_capsule_sequence)
    seq = make_capsule_sequence(n_train + n_val, size, size, bone_rings=2,
                                device=device)

    def split(sl, name, **kw):
        sp = {k: v if k == "betas" else v[sl]
              for k, v in seq["smpl_params"].items()}
        return FrameDataset(seq["images"][sl], seq["masks"][sl], seq["K"],
                            seq["c2w"], sp, name, **kw)
    train = split(slice(0, n_train), "train", sampler=PatchSampler(
        4, 32, 0.9, rng=np.random.default_rng(0)),
        bg_rng=np.random.default_rng(1))
    return seq, train, split(slice(n_train, None), "val")


def train_phase(device, *, size=TRAIN_SIZE, n_train=TRAIN_FRAMES,
                n_val=VAL_FRAMES, steps=TRAIN_STEPS,
                profile_dir: Path | None = None, **config) -> dict:
    """Phases 7 and 8: train on the capsule scene, render the val frames
    with the density eval grid. Returns the measured numbers."""
    from instantavatar_torch.kernels import fused_field_head
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    seq, train, val = capsule_splits(device, size, n_train, n_val)
    print(f"[train] capsule scene {size}px, {n_train}+{n_val} frames: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, mask coverage "
          f"{float(seq['masks'].mean()):.3f}")
    avatar = make_trainer(device, steps_per_epoch=n_train, **config)
    gen = torch.Generator(device=device).manual_seed(0)
    state = avatar.init(seq["smpl_params"]["betas"], generator=gen)
    sync()

    fused_field_head.launches = 0
    fused_field_head.rows = 0
    times = {True: [], False: []}
    peaks = {True: 0, False: 0}
    occ, mse = [], []
    for i in range(steps):
        update = state.step % avatar.grid_update_interval == 0
        batch = train[i % n_train]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, losses = avatar.step(state, batch, gen)
        sync()
        times[update].append((time.perf_counter() - t0) * 1e3)
        if cuda:
            peaks[update] = max(peaks[update],
                                torch.cuda.max_memory_allocated())
        mse.append(float(losses["mse_loss"]))
        check(math.isfinite(float(losses["loss"])), f"loss at step {i}")
        if update:
            occ.append(int(state.grid.occupancy.sum()))
    train_launches = fused_field_head.launches
    train_rows = fused_field_head.rows
    graphs = avatar.step_graphs
    if cuda:
        print(f"[train] {graphs.captures} step graphs captured (one per "
              f"grid-update / warm-up / noise branch), "
              f"{graphs.capture_seconds:.2f} s of capture, warm-ups "
              f"included")
    first, last = statistics.mean(mse[:10]), statistics.mean(mse[-10:])
    res = {"update_ms": statistics.median(times[True]),
           "plain_ms": statistics.median(times[False]),
           "peak_update_mib": peaks[True] / 2 ** 20,
           "peak_plain_mib": peaks[False] / 2 ** 20,
           "mse_first10": first, "mse_last10": last,
           "train_launches": train_launches, "train_rows": train_rows}
    print(f"[train] {steps} steps: median {res['plain_ms']:.2f} ms per "
          f"plain step ({len(times[False])}), {res['update_ms']:.2f} ms per "
          f"grid-update step ({len(times[True])}); first steps "
          f"{[round(t, 1) for t in times[True][:1] + times[False][:2]]} ms")
    print(f"[train] peak memory: update step "
          f"{res['peak_update_mib']:.1f} MiB, plain step "
          f"{res['peak_plain_mib']:.1f} MiB")
    print(f"[train] occupied cells at each update {occ} (cell_budget "
          f"{avatar.cell_budget}, grid {avatar.grid_size}^3)")
    print(f"[train] mse_loss mean of the first 10 steps {first:.5f}, of "
          f"the last 10 {last:.5f} (ratio {last / first:.3f}, bound "
          f"{TRAIN_LOSS_FALL_MAX}); fused-head launches {train_launches}")
    check(last < TRAIN_LOSS_FALL_MAX * first, "the training loss did not fall")
    check(not cuda or train_launches > 0,
          "training never launched the head (the cache bake's sigma sort)")
    if cuda:
        res.update(bake_budget_timing(avatar, state, train[0]))

    fused_field_head.launches = 0
    fused_field_head.rows = 0
    psnrs = []
    t0 = time.perf_counter()
    for j in range(n_val):
        b = val[j]
        out = avatar.render_frame(state, {k: v for k, v in b.items()
                                          if k not in ("rgb", "alpha")},
                                  image_shape=(size, size))
        check(bool(torch.isfinite(out["rgb"]).all()), "non-finite val rgb")
        psnrs.append(psnr(out["rgb"], torch.as_tensor(b["rgb"],
                                                      device=device)))
    sync()
    res["val_ms"] = (time.perf_counter() - t0) * 1e3 / n_val
    res["val_launches"] = fused_field_head.launches
    res["val_rows"] = fused_field_head.rows
    res["val_psnr"] = statistics.mean(psnrs)
    print(f"[val] {n_val} frames at {size}px with eval_grid=density "
          f"(build_test_grid + flat render): {res['val_ms']:.1f} ms/frame, "
          f"PSNR {[round(x, 2) for x in psnrs]} dB, mean "
          f"{res['val_psnr']:.2f} dB (bound {VAL_MIN_DB}; the JAX cached "
          f"arm read {JAX_CACHED_EPOCH5_DB} dB at epoch 5 on a TPU v5e, "
          f"a quality point, not a speed target); fused-head launches "
          f"{res['val_launches']}")
    check(not cuda or res["val_launches"] > 0,
          "the val render never launched the head")
    check(res["val_psnr"] >= VAL_MIN_DB, "val PSNR below its floor")
    if cuda:
        res.update(step_between_validations(
            avatar, state, {k: v for k, v in val[0].items()
                            if k not in ("rgb", "alpha")},
            train[steps % n_train], gen, size))

    if profile_dir is not None and cuda:
        batches = [train[(steps + j) % n_train] for j in range(4)]

        def four_steps():
            nonlocal state
            for j, b in enumerate(batches):
                n_rays = int(np.prod(b["rays_o"].shape[:-1]))
                draws = avatar.draw(gen, n_rays, j == 0)
                step = (avatar.train_step_update if j == 0
                        else avatar.train_step)
                state, _ = step(state, b, draws)
        profile(four_steps, profile_dir, "torch_train_profile",
                "1 grid-update + 3 plain training steps")
    return res


def step_between_validations(avatar, state, frame: dict, batch: dict, gen,
                             size: int) -> dict:
    """Phase 8: validate, take one training step, validate. The frame
    graphs read the parameters at their addresses (their signature holds
    no parameter versions), so the second validation captures nothing
    new, and each validation frame on graphs equals the eager frame at
    its parameters (``graph=False``; PSNR floor FRAME_MIN_DB), the second
    moved by the step."""
    def validate(graph: bool) -> dict:
        out = avatar.render_frame(state, frame, image_shape=(size, size),
                                  graph=graph)
        torch.cuda.synchronize()
        return out
    g0, e0 = validate(True), validate(False)
    fg = avatar.frame_graphs
    c0, r0 = fg.captures, fg.replays
    state, _ = avatar.step(state, batch, gen)
    torch.cuda.synchronize()
    g1, e1 = validate(True), validate(False)
    dbs = (psnr(g0["rgb"], e0["rgb"]), psnr(g1["rgb"], e1["rgb"]))
    err = float((g1["rgb"] - e1["rgb"]).abs().max())
    moved = float((e1["rgb"] - e0["rgb"]).abs().max())
    print(f"[val graph] validate, one training step, validate ({size}px): "
          f"frame graphs captured {fg.captures - c0} anew over "
          f"{fg.replays - r0} replays; graph vs eager PSNR {dbs[0]:.2f} / "
          f"{dbs[1]:.2f} dB (bound {FRAME_MIN_DB}), after the step max "
          f"|rgb diff| {err:.3e}, the step moved the eager frame by "
          f"{moved:.3e}")
    check(fg.captures == c0 and min(dbs) >= FRAME_MIN_DB and err < moved,
          "a validation after a training step recaptured its frame graphs "
          "or read stale parameters")
    return {"recaptures_after_step": fg.captures - c0,
            "val_graph_db": min(dbs)}


def _exact_count_cache(avatar, state, dstate, grid) -> torch.Tensor:
    """The training warp cache by exact count: ``torch.nonzero`` of the
    occupied cells (a host read), the first ``cell_budget`` of them
    baked, no padding."""
    G = avatar.grid_size
    cell_idx = torch.nonzero(grid.occupancy.reshape(-1))[
        :avatar.cell_budget, 0]
    ijk = torch.stack([cell_idx // (G * G), (cell_idx // G) % G,
                       cell_idx % G], dim=-1).float()
    span = grid.aabb[1] - grid.aabb[0]
    rows, _ = avatar.deformer.bake_packed_cache(
        state.deformer_cano, dstate, grid.aabb[0] + (ijk + 0.5) / G * span,
        net_sigma_fn=lambda x: avatar._net(state)(x)[1])
    cache = torch.zeros((G ** 3, rows.shape[-1]), device=rows.device)
    cache[cell_idx] = rows
    return cache


def bake_budget_timing(avatar, state, batch) -> dict:
    """The training bake on the trained state's grid, timed (CUDA events,
    median of 5) with the static ``cell_budget`` (what a step runs) and
    with the exact occupied count (``torch.nonzero``, a host read); both
    caches must agree."""
    with torch.no_grad():
        dstate = avatar._prepare(state.deformer_cano, batch)
        grid = state.grid
        static = avatar._train_cache(state, dstate, grid)
        exact = _exact_count_cache(avatar, state, dstate, grid)
        check(torch.equal(static, exact),
              "the static-budget bake differs from the exact-count one")
        ms = {name: statistics.median(cuda_ms(fn, 5)) for name, fn in (
            ("static", lambda: avatar._train_cache(state, dstate, grid)),
            ("exact", lambda: _exact_count_cache(avatar, state, dstate,
                                                 grid)))}
    n_occ = int(grid.occupancy.sum())
    print(f"[train] the training bake on the trained grid ({n_occ} "
          f"occupied cells, cell_budget {avatar.cell_budget}): static "
          f"budget {ms['static']:.3f} ms, exact count {ms['exact']:.3f} ms "
          f"(CUDA events, median of 5); the caches agree")
    return {"bake_static_ms": ms["static"], "bake_exact_ms": ms["exact"],
            "bake_occupied": n_occ}


def replay_train_golden(device) -> dict:
    """Phase 9: the JAX training golden replayed through the port's
    ``grads_and_losses`` on ``device``; returns the worst gaps."""
    sys.path.insert(0, str(ROOT / "tools"))
    import make_torch_train_golden as golden   # numpy + the port only
    steps = golden.replay_golden(device)
    gaps = [golden.step_gaps(s, s) for s in steps]
    worst = {k: max(g[k] for g in gaps) for k in gaps[0]}
    print(f"[train golden] port on {device} vs JAX on CPU, update + plain "
          f"step: worst loss rel {worst['loss_rel']:.2e} (tol "
          f"{golden.LOSS_RTOL}), reg_density abs "
          f"{worst['reg_density_abs']:.2e} (tol {golden.REG_DENSITY_ATOL}), "
          f"grad rel {worst['grad_rel']:.2e} (tol {golden.GRAD_RTOL}), "
          f"updated-grid cells differing {worst['occ_diff']}")
    check(golden.gaps_within_tolerance(worst), "the training golden disagrees")
    return worst


def _counted(fn, kernel=None):
    """Run ``fn`` with ``kernel``'s counters (default: the head's) at 0;
    returns (result, launches, rows) of that run."""
    from instantavatar_torch.kernels import fused_field_head
    kernel = kernel or fused_field_head
    kernel.launches = 0
    kernel.rows = 0
    out = fn()
    torch.cuda.synchronize()
    return out, kernel.launches, kernel.rows


def _encode_counted(fn, paths: dict, path: str):
    """``_counted`` for the hash-encode kernel; its (launches, rows) go
    to ``paths[path]``. Returns the result."""
    from instantavatar_torch.kernels import hash_encode_cuda
    out, *paths[path] = _counted(fn, hash_encode_cuda)
    return out


# the nearest-vertex kernel's (launches, rows) per path (``knn_path``)
KNN_PATHS: dict[str, tuple[int, int]] = {}
# the warp kernels' (launches, rows, calls of ``SMPLDeformer.deform`` on
# CUDA tensors) per path (``knn_path``)
WARP_PATHS: dict[str, tuple[int, int, int]] = {}


@contextlib.contextmanager
def knn_path(path: str):
    """Count the nearest-vertex kernel's and the warp kernels' launches
    and rows in the block from 0 (each replay of a graph that captured
    them included) into ``KNN_PATHS[path]`` and ``WARP_PATHS[path]``; the
    latter also counts the block's calls of ``SMPLDeformer.deform`` on
    CUDA tensors (a captured graph's replays make no call)."""
    from instantavatar_torch.deformers import SMPLDeformer
    from instantavatar_torch.kernels import (nearest_vertex_cuda,
                                             nearest_warp_cuda)
    nearest_vertex_cuda.launches = nearest_vertex_cuda.rows = 0
    nearest_warp_cuda.launches = nearest_warp_cuda.rows = 0
    calls = [0]
    real = SMPLDeformer.deform

    def deform(self, frame, pts):
        calls[0] += int(pts.is_cuda)
        return real(self, frame, pts)
    SMPLDeformer.deform = deform
    try:
        yield
    finally:
        SMPLDeformer.deform = real
    torch.cuda.synchronize()
    KNN_PATHS[path] = (nearest_vertex_cuda.launches, nearest_vertex_cuda.rows)
    WARP_PATHS[path] = (nearest_warp_cuda.launches, nearest_warp_cuda.rows,
                        calls[0])


def cli_overrides(seq: Path, run: Path) -> list[str]:
    """The entry points' overrides for phase 11's sequence: its frame
    ranges (CLI_TRAIN train, CLI_VAL val, CLI_TEST test frames at full
    size) and the run directory; every other key at its conf default."""
    v0, t0 = CLI_TRAIN, CLI_TRAIN + CLI_VAL
    n = t0 + CLI_TEST
    return [f"dataset.opt.dataroot={seq}", f"run_dir={run}",
            "dataset.opt.train.start=0", f"dataset.opt.train.end={v0 - 1}",
            "dataset.opt.train.skip=1", "dataset.opt.train.downscale=1",
            f"dataset.opt.val.start={v0}", f"dataset.opt.val.end={v0}",
            "dataset.opt.val.skip=1", "dataset.opt.val.downscale=1",
            f"dataset.opt.test.start={t0}", f"dataset.opt.test.end={n - 1}",
            "dataset.opt.test.skip=1", "dataset.opt.test.downscale=1"]


def write_poses(path: Path) -> None:
    """The CLI_POSES-pose ``animate`` sequence (numpy-seeded: a yaw sweep,
    swinging arms, small noise) as ``poses.npz``."""
    g = np.random.default_rng(0)
    poses = np.zeros((CLI_POSES, 72), np.float32)
    poses[:, 1] = np.linspace(-0.6, 0.6, CLI_POSES)     # yaw
    poses[:, 3 + 47] = 0.6 * np.sin(np.arange(CLI_POSES))
    poses[:, 3 + 50] = -0.6 * np.sin(np.arange(CLI_POSES))
    poses[:, 3:] += 0.05 * g.standard_normal((CLI_POSES, 69))
    trans = np.tile(np.array([[0.0, 0.0, 3.0]], np.float32), (CLI_POSES, 1))
    np.savez(path, poses=poses, trans=trans)


def cli_phase(dev, work: Path) -> dict:
    """Phase 11: the entry points a user runs, in process, on the card
    (their default device). Returns the measured numbers and, per path,
    the head's launches and rows."""
    from instantavatar_torch.cli import animate, novel_view, train
    from instantavatar_torch.data import make_synthetic_sequence
    from instantavatar_torch.utils.image_io import read_png
    n = CLI_TRAIN + CLI_VAL + CLI_TEST
    t0 = time.perf_counter()
    seq = make_synthetic_sequence(work / "seq", n_frames=n, H=CLI_SIZE,
                                  W=CLI_SIZE, style="capsule", device=dev)
    print(f"[cli] capsule sequence {CLI_SIZE}px, {n} frames written to "
          f"PNG/npy: {time.perf_counter() - t0:.2f} s")
    run = work / "run"
    over = cli_overrides(seq, run) + ["network=voxel_triplane"]
    args = ["--config-name", "SNARF_NGP", f"train.max_epochs={CLI_EPOCHS}",
            f"train.check_val_every_n_epoch={CLI_EPOCHS}", *over]
    paths, res = {}, {}

    t0 = time.perf_counter()
    (trainer, state), *paths["cli_train"] = _counted(lambda: train.main(args))
    res["train_cli_s"] = time.perf_counter() - t0
    steps = CLI_EPOCHS * CLI_TRAIN
    check(state.step == steps and trainer.steps_run == steps,
          f"the train CLI took {trainer.steps_run} steps, not {steps}")
    res["ms_per_step"] = 1e3 * sum(trainer.epoch_seconds) / steps
    res["batch_ms"] = 1e3 * trainer.batch_seconds / steps
    cache = trainer.dm.trainset.native_cache
    check(cache is not None, "the train CLI's train split did not run on "
          "the native data engine (its default)")
    check(not trainer.dm.valset.native_active,
          "the val split runs on the native engine (JAX's default: not)")
    res["native_decode_ms"] = 1e3 * cache.decode_seconds
    print(f"[cli] train: {steps} steps, {res['ms_per_step']:.2f} ms/step "
          f"(batches from the native engine included, their assembly "
          f"{res['batch_ms']:.2f} ms/step of host time: "
          f"{[round(1e3 * s / CLI_TRAIN, 1) for s in trainer.epoch_seconds]} "
          f"ms/step by epoch); the whole CLI {res['train_cli_s']:.1f} s; "
          f"the engine's load decoded the {CLI_TRAIN} frames once, with "
          f"read_png, in {res['native_decode_ms']:.1f} ms")

    t0 = time.perf_counter()
    (trainer, state), *paths["cli_val_render"] = _counted(
        lambda: train.main(args))
    res["rerun_s"] = time.perf_counter() - t0
    check(trainer.steps_run == 0 and state.step == steps,
          "the rerun of the train CLI did not resume as a no-op")
    val_psnr = [json.loads(line)["value"] for line in
                (run / "tensorboard" / "scalars.jsonl").read_text()
                .splitlines() if '"val/psnr"' in line][-1]
    gt = torch.as_tensor(trainer.dm.valset[0]["rgb"])
    white_db = psnr(torch.ones_like(gt), gt)
    res["val_psnr"], res["white_psnr"] = val_psnr, white_db
    val_m = trainer.test(state, split="val")
    res["val_ssim"] = val_m["ssim"]
    print(f"[cli] rerun ({res['rerun_s']:.2f} s: build, restore, the final "
          f"validation) resumed with no step; its validation render: val "
          f"PSNR {val_psnr:.2f} dB (an all-white frame: {white_db:.2f} dB), "
          f"SSIM {val_m['ssim']:.4f}")
    check(val_psnr > white_db, "val PSNR does not beat an all-white frame")

    test_m, *paths["cli_test_render"] = _counted(lambda: trainer.test(state))
    res["test_psnr"], res["test_ssim"] = test_m["psnr"], test_m["ssim"]
    text = (run / "results.txt").read_text()
    check("psnr: " in text and "ssim: " in text and "lpips: SKIPPED" in text,
          "results.txt lacks its metrics")
    print(f"[cli] Trainer.test: PSNR {test_m['psnr']:.2f} dB, SSIM "
          f"{test_m['ssim']:.4f} over {CLI_TEST} frames")

    write_poses(work / "poses.npz")
    rd = "+render_downscale=2"
    with knn_path("cli_animate"):
        anim, *paths["cli_animate"] = _counted(lambda: animate.main(
            ["--config-name", "SNARF_NGP",
             f"+pose_sequence={work / 'poses.npz'}", rd, *over]))
    with knn_path("cli_novel_view"):
        nv, *paths["cli_novel_view"] = _counted(lambda: novel_view.main(
            ["--config-name", "SNARF_NGP", rd, f"+n_frames={CLI_TURNTABLE}",
             *over]))
    for tag, out, frames in (("animation", anim, CLI_POSES),
                             ("novel_view", nv, CLI_TURNTABLE)):
        res[f"{tag}_ms_per_frame"] = 1e3 * out["render_s"] / out["frames"]
        res[f"{tag}_png_ms_per_frame"] = 1e3 * out["png_s"] / out["frames"]
        res[f"{tag}_gif_s"] = out["gif_s"]
        check(out["frames"] == frames and out["nonfinite_frames"] == 0,
              f"{tag}: {out['nonfinite_frames']} non-finite frames")
        check(all(0.02 < c < 0.95 for c in out["alpha_coverage"]),
              f"{tag}: implausible alpha coverage {out['alpha_coverage']}")
        png = read_png(run / tag / f"{frames - 1:04d}.png")
        check(png.shape == (540, 540, 4), f"{tag}: frame shape {png.shape}")
        print(f"[cli] {tag}: {frames} frames at 540px, "
              f"{res[f'{tag}_ms_per_frame']:.2f} ms/frame rendered to host "
              f"memory, PNG write {res[f'{tag}_png_ms_per_frame']:.2f} "
              f"ms/frame, GIF write {out['gif_s']:.3f} s; alpha coverage "
              f"{min(out['alpha_coverage']):.3f}-"
              f"{max(out['alpha_coverage']):.3f}")
    for f in ("config.yaml", "results.txt", "test/0.png",
              f"val/epoch_{CLI_EPOCHS - 1:04d}.png",
              f"val/cano_pose_{CLI_EPOCHS:04d}.png",
              "animation/animation.gif", "novel_view/novel_view.gif"):
        check((run / f).is_file(), f"the CLIs did not write {f}")
    check(len(list((run / "checkpoints").glob("step_*"))) >= 1,
          "no checkpoint written")
    for path, (launches, rows) in paths.items():
        check(launches > 0, f"{path} never launched the CUDA head")
        print(f"[cli] {path}: fused-head launches {launches}, rows per "
              f"launch {rows / launches:.0f}")
    res["paths"] = paths
    return res


def _record_calls(module, attr: str, describe, steps_only: bool = False):
    """Record ``describe(*args)`` -> (entry, points) of every call of
    ``module.attr`` (the name its callers read) until the returned
    ``stop`` is called, and keep the points of the largest call;
    wrappers, no device sync. With ``steps_only``, the calls of training
    steps only (a training run's validation renders are left out): an
    eager step's calls, and for a step that replays a captured graph the
    calls its capture made, which each replay repeats (the warm-up
    before a capture is not a step)."""
    from instantavatar_torch.train import AvatarModel
    from instantavatar_torch.train.step_graph import StepGraphs
    real = getattr(module, attr)
    real_gl = AvatarModel.grads_and_losses
    real_capture, real_run = StepGraphs._capture, StepGraphs.run
    calls: list = []
    largest: dict = {"x": None}
    sink = [None if steps_only else calls]   # where a call is recorded
    capturing: list = [None]                 # the capture's own list
    captured: dict = {}                      # (graphs, key) -> calls

    def counted(*a, **kw):
        if sink[0] is not None:
            entry, x = describe(*a)
            sink[0].append(entry)
            if largest["x"] is None or x.shape[0] > largest["x"].shape[0]:
                largest["x"] = x.detach().clone()
        return real(*a, **kw)

    def grads_and_losses(self, *a, **kw):
        cap = capturing[0]
        prev, sink[0] = sink[0], (calls if cap is None else
                                  cap if kw.get("in_place") else None)
        try:
            return real_gl(self, *a, **kw)
        finally:
            sink[0] = prev

    def capture(self, state, key, *a):
        capturing[0] = []
        try:
            return real_capture(self, state, key, *a)
        finally:
            captured[(id(self), key)], capturing[0] = capturing[0], None

    def run(self, state, *a, **kw):
        out = real_run(self, state, *a, **kw)
        calls.extend(captured[(id(self), self.key(
            state, kw.get("update"), kw.get("reduce")))])
        return out

    def stop():
        setattr(module, attr, real)
        AvatarModel.grads_and_losses = real_gl
        StepGraphs._capture, StepGraphs.run = real_capture, real_run
    setattr(module, attr, counted)
    if steps_only:
        AvatarModel.grads_and_losses = grads_and_losses
        StepGraphs._capture, StepGraphs.run = capture, run
    return calls, largest, stop


def _count_encode(steps_only: bool = False):
    """``hash_encode`` calls of the NGP field: (rows, with autograd)."""
    import instantavatar_torch.models.ngp as ngp_mod

    def describe(table, x, *_):
        return ((x.numel() // 3, torch.is_grad_enabled()
                 and (table.requires_grad or x.requires_grad)),
                x.reshape(-1, 3))
    return _record_calls(ngp_mod, "hash_encode", describe, steps_only)


def device_launches(fn) -> int:
    """Device kernels one call of ``fn`` launches (torch.profiler), after
    one warm call."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def device_busy(fn, top: int = 5) -> tuple[int, float, list]:
    """Device kernels one call of ``fn`` launches, the ms they run for in
    all, and the ``top`` kernel names by summed ms with (count, ms)
    (torch.profiler), after one warm call."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, tuple[int, float]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return (sum(n for n, _ in by_name.values()),
            sum(ms for _, ms in by_name.values()), ranked[:top])


def encode_bound(rows: int, touched: int, *, forward: bool = True,
                 table_grad: bool = False, point_grad: bool = False,
                 cfg=None) -> float:
    """Least time (ms) of a ``hash_encode`` call on ``rows`` points that
    touch ``touched`` distinct table rows of the (L, T, F) table of
    ``cfg`` (the default grid if None), at the HBM rate (the FLOPs, ~60
    per point and level, take <1% of that at the fp32 rate): 12 B of
    points in per point and F * 4 B per touched table row; with
    ``forward`` L * F * 4 B of fp32 features out per point; with either
    gradient the L * F * 4 B per point of incoming gradient; with
    ``table_grad`` the dense L * T * F * 4 B table gradient written once;
    with ``point_grad`` 12 B per point of the points' gradient."""
    from instantavatar_torch.ops import HashGridConfig
    cfg = cfg or HashGridConfig()
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    nbytes = rows * 12 + touched * F * 4
    if forward:
        nbytes += rows * L * F * 4
    if table_grad or point_grad:
        nbytes += rows * L * F * 4
    if table_grad:
        nbytes += L * T * F * 4
    if point_grad:
        nbytes += rows * 12
    return 1e3 * nbytes / HBM_BYTES_PER_S


def encode_inputs(n: int, seed: int, device, cfg=None):
    """``n`` points for the grid ``cfg`` (the default grid if None),
    numpy-seeded: uniform in [-0.1,
    1.1]^3 with every fifth row (from row 1) an axis at exactly 0, every
    fifth (from row 2) an axis at exactly 1, every fifth (from row 3) on a
    lattice point of a random level and every fifth (from row 4) a copy of
    row 0 whose gradient is zero (a static budget's padding); a N(0, 0.1)
    table and an N(0, 1) gradient of the features. Returns (table, x,
    grad) on ``device``."""
    from instantavatar_torch.ops import HashGridConfig, level_resolutions
    cfg = cfg or HashGridConfig()
    res = np.array(level_resolutions(cfg))
    g = np.random.default_rng(seed)
    x = g.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    axis = g.integers(0, 3, n)
    rows = np.arange(n)
    x[rows[1::5], axis[1::5]] = 0.0
    x[rows[2::5], axis[2::5]] = 1.0
    lat = rows[3::5]
    r = res[g.integers(0, len(res), lat.size)][:, None]
    x[lat] = (g.integers(0, r + 1, (lat.size, 3)) / r).astype(np.float32)
    table = g.normal(0.0, 0.1, (cfg.n_levels, cfg.table_size,
                                cfg.n_features)).astype(np.float32)
    grad = g.normal(size=(n, cfg.out_dim)).astype(np.float32)
    x[4::5], grad[4::5] = x[0], 0.0
    return tuple(torch.as_tensor(a, device=device) for a in (table, x, grad))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def encode_check(dev, n: int, seed: int, deterministic: bool = False,
                 keep: bool = False, cfg=None) -> dict:
    """The hash-encode kernel, forward and backward (atomic, or the
    sorted run sum under deterministic algorithms), against
    ``hash_encode_ref`` and ``hash_encode_backward_ref`` on
    ``encode_inputs(n, seed, cfg)`` (the default grid if ``cfg`` is None):
    the features' max abs error, the table's
    and the points' gradients' L2-relative errors, the kernel's launches;
    with ``keep`` also the kernel's outputs."""
    from instantavatar_torch.kernels import hash_encode_cuda
    from instantavatar_torch.ops import (HashGridConfig,
                                         hash_encode_backward_ref,
                                         hash_encode_ref, level_resolutions)
    cfg = cfg or HashGridConfig()
    table, x, grad = encode_inputs(n, seed, dev, cfg)
    tt, xt = table.clone().requires_grad_(), x.clone().requires_grad_()
    launches = hash_encode_cuda.launches
    torch.use_deterministic_algorithms(deterministic)
    try:
        out = hash_encode_cuda(tt, xt, level_resolutions(cfg))
        out.backward(grad)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    res = {"launches": hash_encode_cuda.launches - launches}
    with torch.no_grad():
        ref = hash_encode_ref(table, x, cfg)
        g_tab, g_x = hash_encode_backward_ref(table, x, grad, cfg)
        res["finite"] = bool(torch.isfinite(out).all())
        res["feat_err"] = float((out - ref).abs().max())
        res["grad_table_rel"] = _rel(tt.grad, g_tab)
        res["grad_x_rel"] = _rel(xt.grad, g_x)
    if keep:
        res.update(out=out.detach(), grad_table=tt.grad, grad_x=xt.grad)
    return res


def encode_grids():
    """The grids the kernel is held at besides the default: every
    compiled feature width (1, 4, 8), one width the feature loop takes
    (3), and 40 levels (past the earlier limit of 32), each with dense and
    hashed levels."""
    from instantavatar_torch.ops import HashGridConfig
    return [HashGridConfig(n_features=f) for f in (1, 4, 8, 3)] + [
        HashGridConfig(n_levels=40, log2_hashmap_size=14, base_resolution=4,
                       per_level_scale=1.2)]


def _encode_checked(r: dict, what: str, launches: int) -> None:
    print(f"[encode] kernel vs plain, {what} (boundary, lattice and "
          f"out-of-range rows): features max|diff| {r['feat_err']:.2e} "
          f"(tol {ENCODE_FEAT_TOL}), table gradient "
          f"{r['grad_table_rel']:.2e} and point gradient "
          f"{r['grad_x_rel']:.2e} L2-relative (tol {ENCODE_GRAD_RTOL}), "
          f"{r['launches']} launches")
    check(r["finite"] and r["feat_err"] <= ENCODE_FEAT_TOL
          and r["grad_table_rel"] <= ENCODE_GRAD_RTOL
          and r["grad_x_rel"] <= ENCODE_GRAD_RTOL
          and r["launches"] == launches,
          f"the hash-encode kernel disagrees at {what}")


def encode_checks(dev) -> float:
    """The kernel against its plain version at ENCODE_CHECK_N on the
    default grid and at ENCODE_GRID_N on each of ``encode_grids`` (default
    mode), and the deterministic backward bit-identical on two runs at the
    largest N and on each grid; returns the features' largest
    max|diff|."""
    worst = 0.0
    runs = [(n, None, f"{n} points") for n in ENCODE_CHECK_N] + [
        (ENCODE_GRID_N, cfg, f"{ENCODE_GRID_N} points, {cfg.n_levels} "
         f"levels of {cfg.n_features} features, T = 2^"
         f"{cfg.log2_hashmap_size}") for cfg in encode_grids()]
    for n, cfg, what in runs:
        r = encode_check(dev, n, seed=n, cfg=cfg)
        _encode_checked(r, what, 3)
        worst = max(worst, r["feat_err"])
    for n, cfg, what in [runs[len(ENCODE_CHECK_N) - 1]] + runs[
            len(ENCODE_CHECK_N):]:
        one, two = (encode_check(dev, n, seed=1, deterministic=True,
                                 keep=True, cfg=cfg) for _ in range(2))
        same = all(torch.equal(one[k], two[k])
                   for k in ("out", "grad_table", "grad_x"))
        print(f"[encode] deterministic backward, {what}: table gradient "
              f"{one['grad_table_rel']:.2e} L2-relative from the plain "
              f"version, {one['launches']} launches; two runs "
              f"bit-identical: {same}")
        check(same, f"the deterministic hash-encode backward is not "
              f"reproducible at {what}")
        _encode_checked(one, what + ", deterministic", 5)
    return worst


def encode_path_check(path: str, table: torch.Tensor, x: torch.Tensor,
                      ct: torch.Tensor, cfg) -> float:
    """The kernel (``hash_encode`` on the card) against ``hash_encode_ref``
    and ``hash_encode_backward_ref`` on one path's own points and the
    features' gradient that ``encode_timing`` times: features within
    ENCODE_FEAT_TOL, the table's and the points' gradients within
    ENCODE_GRAD_RTOL L2-relative. Returns the features' max|diff|."""
    from instantavatar_torch.ops import (hash_encode,
                                         hash_encode_backward_ref,
                                         hash_encode_ref)
    tt, xt = table.clone().requires_grad_(), x.clone().requires_grad_()
    out = hash_encode(tt, xt, cfg)
    out.backward(ct)
    with torch.no_grad():
        finite = bool(torch.isfinite(out).all())
        feat = float((out - hash_encode_ref(table, x, cfg)).abs().max())
        g_tab, g_x = hash_encode_backward_ref(table, x, ct, cfg)
        tab_rel, x_rel = _rel(tt.grad, g_tab), _rel(xt.grad, g_x)
    del out, tt, xt, g_tab, g_x
    print(f"[encode] {path}: kernel vs plain on the path's {x.shape[0]} "
          f"points: features max|diff| {feat:.2e} (tol {ENCODE_FEAT_TOL}), "
          f"table gradient {tab_rel:.2e} and point gradient {x_rel:.2e} "
          f"L2-relative (tol {ENCODE_GRAD_RTOL})")
    check(finite and feat <= ENCODE_FEAT_TOL and tab_rel <= ENCODE_GRAD_RTOL
          and x_rel <= ENCODE_GRAD_RTOL,
          f"the hash-encode kernel disagrees on {path}'s points")
    return feat


@contextlib.contextmanager
def _hash_library(info):
    """The hash-encode wrapper runs on the build ``info`` (a ``BuildInfo``
    of a source with ``csrc/hash_encode.cu``'s C interface) inside the
    block; None leaves it on the checkout's."""
    import instantavatar_torch.kernels.hash_encode as kmod
    build = kmod.build_hash_library
    if info is not None:
        kmod.build_hash_library = lambda: info
    try:
        yield
    finally:
        kmod.build_hash_library = build


def encode_timing(dev, path_points: dict[str, torch.Tensor],
                  libs: dict | None = None) -> dict:
    """The hash encode on each path's largest call (its normalized
    points, as the field encoded them; random table), after
    ``encode_checks`` and, on the same points, ``encode_path_check``: the
    kernel and the plain version (``hash_encode_ref``) in turns, median of
    ENCODE_REPS (CUDA events), with their device launches per call
    (torch.profiler) and the bound: forward; forward plus the table's
    backward (a training step's call; the kernel's deterministic backward
    too); forward plus both gradients (fit's and refine's call, the points
    requiring grad); the points' backward alone (its one kernel). The
    features' gradient is zero on padding rows, as in a training step.
    ``libs`` (name -> ``BuildInfo`` of another build of the source, same C
    interface) are each held against the plain version on the paths'
    points and timed in the same turns, under their names."""
    from instantavatar_torch.ops import (HashGridConfig, hash_encode,
                                         hash_encode_ref, hash_slots)
    cfg = HashGridConfig()
    builds = {"kernel": None, **(libs or {})}
    out = {"max_err": encode_checks(dev)}
    g = np.random.default_rng(3)
    table = torch.as_tensor(g.normal(0.0, 0.1, (cfg.n_levels, cfg.table_size,
                                                cfg.n_features))
                            .astype(np.float32), device=dev)
    for path, x in path_points.items():
        rows = x.shape[0]
        slots = hash_slots(x, cfg)                   # (N, L, 8), per level
        touched_by_level = [int(torch.unique(slots[:, l]).numel())
                            for l in range(cfg.n_levels)]
        touched = sum(touched_by_level)
        del slots
        tab = table.clone().requires_grad_()
        # the features' gradient: ones, but zero on a point that repeats
        # the point before it (a static budget's padding, the ray's first
        # sample again, whose gradient the step masks to zero)
        pad = torch.zeros(rows, dtype=torch.bool, device=dev)
        pad[1:] = (x[1:] == x[:-1]).all(-1)
        ct = (~pad).float()[:, None].expand(rows, cfg.out_dim).contiguous()
        for name, info in builds.items():
            with _hash_library(info):
                err = encode_path_check(f"{path} ({name})", table, x, ct,
                                        cfg)
            if info is None:
                out["max_err"] = max(out["max_err"], err)

        def on(info, fn):
            def run():
                with _hash_library(info):
                    fn()
            return run

        def fwd(fn):
            def run():
                with torch.no_grad():
                    fn(table, x, cfg)
            return run

        def fwd_bwd(fn, deterministic=False, points=False):
            xg = x.clone().requires_grad_(points)

            def run():
                tab.grad = xg.grad = None
                torch.use_deterministic_algorithms(deterministic)
                try:
                    fn(tab, xg, cfg).backward(ct)
                finally:
                    torch.use_deterministic_algorithms(False)
            return run

        def bwd_x(fn, info=None):
            xg = x.clone().requires_grad_()
            with _hash_library(info):
                feats = fn(table, xg, cfg)
            return lambda: torch.autograd.grad(feats, xg, ct,
                                               retain_graph=True)

        def kernels(make):
            return {name: on(info, make(info)) for name, info in
                    builds.items()}
        res = {"rows": rows, "touched_rows": touched,
               "padded_rows": int(pad.sum())}
        print(f"[encode] {path}: {rows} points, {res['padded_rows']} of them "
              f"a repeat of the point before (gradient zero in the timed "
              f"backward)")
        variants = (
            ("fwd", lambda: {**kernels(lambda i: fwd(hash_encode)),
                             "plain": fwd(hash_encode_ref)},
             dict(forward=True)),
            ("fwd_bwd", lambda: {**kernels(lambda i: fwd_bwd(hash_encode)),
                                 "plain": fwd_bwd(hash_encode_ref),
                                 "kernel_det": fwd_bwd(hash_encode, True)},
             dict(table_grad=True)),
            ("fwd_bwd_x", lambda: {
                **kernels(lambda i: fwd_bwd(hash_encode, points=True)),
                "plain": fwd_bwd(hash_encode_ref, points=True)},
             dict(table_grad=True, point_grad=True)),
            ("bwd_x", lambda: {**kernels(lambda i: bwd_x(hash_encode, i)),
                               "plain": bwd_x(hash_encode_ref)},
             dict(forward=False, point_grad=True)))
        for name, make_fns, parts in variants:
            fns = make_fns()
            times = {k: [] for k in fns}
            for fn in fns.values():
                for _ in range(2):
                    fn()
            for i in range(ENCODE_REPS):   # in turns, the order alternating
                for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
                    times[k] += cuda_ms(fns[k], 1)
            bound = encode_bound(rows, touched, **parts)
            res[f"{name}_bound_ms"] = bound
            for k, fn in fns.items():
                ms = statistics.median(times[k])
                launches = device_launches(fn)
                res[f"{name}_{k}_ms"] = ms
                res[f"{name}_{k}_launches"] = launches
                print(f"[encode] {path}: {rows} points ({touched} distinct "
                      f"table rows), {name} {k}: {ms:.4f} ms (median of "
                      f"{ENCODE_REPS}, CUDA events, in turns), {launches} "
                      f"device launches per call (torch.profiler), bound "
                      f"{bound:.4f} ms set by bytes, {100 * bound / ms:.1f}% "
                      f"of it")
            del fns
            print(f"[encode] {path}: {name} kernel "
                  f"{res[f'{name}_plain_ms'] / res[f'{name}_kernel_ms']:.1f}x "
                  f"faster than the plain version" + "".join(
                      f"; {k} / kernel "
                      f"{res[f'{name}_{k}_ms'] / res[f'{name}_kernel_ms']:.3f}"
                      for k in builds if k != "kernel"))
        res["groups"] = {}
        for name, info in builds.items():
            with _hash_library(info):
                res["groups"][name] = encode_groups(
                    f"{path} ({name})", table, x, ct, cfg, touched_by_level)
        out[path] = res
    return out


# csrc/hash_encode.cu: kForwardFloats, the floats of a point's row that
# one level group of the forward fills
ENCODE_GROUP_FLOATS = 8


def encode_groups(path: str, table: torch.Tensor, x: torch.Tensor,
                  ct: torch.Tensor, cfg, touched: list[int]) -> list[dict]:
    """The kernel by level group on one path's points: each group of the
    forward's G levels (ENCODE_GROUP_FLOATS / F, one 32-byte sector of a
    point's features; 4 at F = 2) alone, on a view of the table (its
    contiguous (G, T, F) slice, its resolutions), forward and forward plus
    the table's backward (that group's slice of the features' gradient),
    median of ENCODE_GROUP_REPS (CUDA events), beside the group's byte
    bound (``encode_bound`` of a G-level grid: the points, the group's
    features and its distinct rows; with the backward its gradient slice
    and its (G, T, F) table gradient). The forward runs a view as it runs
    that group of the whole table; the table's backward, whose groups are
    whole rows of the whole table (16 levels at F = 2), runs a G-level
    view in groups of G. The groups' sum reads the points once a group."""
    from instantavatar_torch.ops import hash_encode, level_resolutions
    res = level_resolutions(cfg)
    L, F = cfg.n_levels, cfg.n_features
    G = ENCODE_GROUP_FLOATS // F if F in (1, 2, 4, 8) else 1
    rows = x.shape[0]
    g = ct.view(rows, L, F)
    out = []
    for l0 in range(0, L, G):
        l1 = min(l0 + G, L)
        view = cfg._replace(n_levels=l1 - l0)
        tab = table[l0:l1]
        tab_g = tab.clone().requires_grad_()
        g_v = g[:, l0:l1].reshape(rows, (l1 - l0) * F).contiguous()
        rows_hit = sum(touched[l0:l1])

        def fwd():
            with torch.no_grad():
                hash_encode(tab, x, view, res[l0:l1])

        def fwd_bwd():
            tab_g.grad = None
            hash_encode(tab_g, x, view, res[l0:l1]).backward(g_v)
        r = {"levels": (l0, l1 - 1), "res": res[l0:l1],
             "touched_rows": rows_hit,
             "dense": [(r_ + 1) ** 3 <= cfg.table_size for r_ in res[l0:l1]]}
        for name, fn, tg in (("fwd", fwd, False), ("fwd_bwd", fwd_bwd, True)):
            fn()
            r[f"{name}_ms"] = statistics.median(cuda_ms(fn, ENCODE_GROUP_REPS))
            r[f"{name}_bound_ms"] = encode_bound(rows, rows_hit,
                                                 table_grad=tg, cfg=view)
        out.append(r)
        kind = ("dense" if all(r["dense"]) else "hashed"
                if not any(r["dense"]) else "dense and hashed")
        print(f"[encode] {path} levels {l0}-{l1 - 1} (res {res[l0]}-"
              f"{res[l1 - 1]}, {kind}, {rows_hit} rows touched): forward "
              f"{r['fwd_ms']:.4f} ms, "
              f"{100 * r['fwd_bound_ms'] / r['fwd_ms']:.1f}% of its "
              f"{r['fwd_bound_ms']:.4f} ms bound; with the backward "
              f"{r['fwd_bwd_ms']:.4f} ms, "
              f"{100 * r['fwd_bwd_bound_ms'] / r['fwd_bwd_ms']:.1f}% of "
              f"{r['fwd_bwd_bound_ms']:.4f} ms (median of "
              f"{ENCODE_GROUP_REPS}, a {l1 - l0}-level view)")
        del tab_g
    print(f"[encode] {path}: the {len(out)} group calls sum to forward "
          f"{sum(r['fwd_ms'] for r in out):.4f} ms, with the backward "
          f"{sum(r['fwd_bwd_ms'] for r in out):.4f} ms")
    return out


def ngp_phase(dev, work: Path) -> dict:
    """Phase 12: the confs' default network (NGPField, the default hash
    grid) through the entry points on phase 11's sequence, with no
    network override: train, refine (eval), fit on a copy, animate; then
    the hash encode timed at the rows of the training step and of an
    animate frame, and the committed JAX NGP golden frame."""
    import shutil
    from instantavatar_torch.cli import animate, fit, train
    from instantavatar_torch.cli import eval as eval_cli
    sys.path.insert(0, str(ROOT / "tools"))
    import make_torch_ngp_golden as ngp_golden   # numpy + the port only
    seq = work / "seq"
    run = work / "ngp_run"
    over = cli_overrides(seq, run)
    res, paths = {}, {}   # paths: the encode kernel's (launches, rows)

    # -- train ----------------------------------------------------------------
    calls, train_x, stop = _count_encode(steps_only=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, state = _encode_counted(lambda: train.main(
        ["--config-name", "SNARF_NGP", f"train.max_epochs={CLI_EPOCHS}",
         f"train.check_val_every_n_epoch={CLI_EPOCHS}", *over]),
        paths, "ngp_train_cli")
    torch.cuda.synchronize()
    stop()
    res["train_cli_s"] = time.perf_counter() - t0
    steps = CLI_EPOCHS * CLI_TRAIN
    check(type(trainer.avatar.field).__name__ == "NGPField",
          "the default network is not NGPField")
    check(state.step == steps and trainer.steps_run == steps,
          f"the NGP train CLI took {trainer.steps_run} steps, not {steps}")
    res["ms_per_step"] = 1e3 * sum(trainer.epoch_seconds) / steps
    res["batch_ms"] = 1e3 * trainer.batch_seconds / steps
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    val_psnr = [json.loads(line)["value"] for line in
                (run / "tensorboard" / "scalars.jsonl").read_text()
                .splitlines() if '"val/psnr"' in line][-1]
    gt = torch.as_tensor(trainer.dm.valset[0]["rgb"])
    white_db = psnr(torch.ones_like(gt), gt)
    res["val_psnr"], res["white_psnr"] = val_psnr, white_db
    grad_rows = [r for r, gr in calls if gr]
    res["train_encode"] = {"calls": len(calls), "grad_calls": len(grad_rows),
                           "rows": sum(r for r, _ in calls),
                           "grad_rows": sum(grad_rows),
                           "max_rows": max(r for r, _ in calls)}
    print(f"[ngp] train (SNARF_NGP, no network override): {steps} steps, "
          f"{res['ms_per_step']:.2f} ms/step (batches from the native "
          f"engine included, "
          f"their assembly {res['batch_ms']:.2f} ms/step); by epoch "
          f"{[round(1e3 * s / CLI_TRAIN, 1) for s in trainer.epoch_seconds]} "
          f"ms/step; peak memory {res['peak_mib']:.1f} MiB; the whole CLI "
          f"{res['train_cli_s']:.1f} s; val PSNR {val_psnr:.2f} dB (an "
          f"all-white frame: {white_db:.2f} dB)")
    print(f"[ngp] hash_encode in the train CLI run's {steps} steps: "
          f"{len(calls)} calls, {len(grad_rows)} with autograd, "
          f"{res['train_encode']['rows']} points "
          f"({res['train_encode']['grad_rows']} with autograd), the largest "
          f"call {res['train_encode']['max_rows']} points")
    check(val_psnr > white_db, "NGP val PSNR does not beat an all-white frame")
    ck = sorted((run / "checkpoints").glob("step_*"))[-1]
    field0 = torch.load(ck / "state.pt", weights_only=True,
                        map_location=dev)["field"]

    # -- refine -----------------------------------------------------------
    del trainer, state   # a CLI's model, and its graphs' memory, go with it
    t0 = time.perf_counter()
    rtrainer, rstate, test_m = _encode_counted(lambda: eval_cli.main(
        ["--config-name", "SNARF_NGP_refine", *over]), paths, "ngp_refine")
    torch.cuda.synchronize()
    res["refine_cli_s"] = time.perf_counter() - t0
    rsteps = rtrainer.max_epochs * CLI_TEST
    check(rstate.step == rsteps and rtrainer.steps_run == rsteps,
          f"refine took {rtrainer.steps_run} steps, not {rsteps}")
    res["refine_ms_per_step"] = 1e3 * sum(rtrainer.epoch_seconds) / rsteps
    same = all(torch.equal(v, field0[k])
               for k, v in rtrainer.avatar.field.state_dict().items())
    sp = rtrainer.dm.trainset.get_smpl_params()
    moved = {k: float(np.abs(getattr(rstate.smpl, k).detach().cpu().numpy()
                             - sp[k]).max())
             for k in ("global_orient", "body_pose", "transl")}
    text = (run / "results.txt").read_text()
    res["test_psnr"], res["test_ssim"] = test_m["psnr"], test_m["ssim"]
    print(f"[ngp] refine (eval, SNARF_NGP_refine): {rsteps} steps over "
          f"{CLI_TEST} test frames, {res['refine_ms_per_step']:.2f} ms/step, "
          f"the whole CLI {res['refine_cli_s']:.1f} s; field bit-identical "
          f"to the train checkpoint: {same}; SMPL moved (max |change|) "
          f"{moved}; results.txt: test PSNR {test_m['psnr']:.2f} dB, SSIM "
          f"{test_m['ssim']:.4f}")
    check(same, "refinement changed the field")
    check(moved["body_pose"] > 0 and moved["transl"] > 0,
          "refinement did not move the SMPL parameters")
    check("psnr: " in text and "ssim: " in text
          and (run / "test" / "0.png").is_file(),
          "eval did not write results.txt and test/*.png")

    # -- fit on a copy of the sequence ---------------------------------------
    del rtrainer, rstate
    seq_fit = work / "seq_fit"
    shutil.copytree(seq, seq_fit)
    t0 = time.perf_counter()
    ftrainer, fstate, poses = _encode_counted(lambda: fit.main(
        ["--config-name", "SNARF_NGP_fitting",
         f"train.max_epochs={FIT_EPOCHS}",
         *cli_overrides(seq_fit, work / "fit_run")]), paths, "ngp_fit")
    torch.cuda.synchronize()
    res["fit_cli_s"] = time.perf_counter() - t0
    fsteps = FIT_EPOCHS * CLI_TRAIN
    res["fit_ms_per_step"] = 1e3 * sum(ftrainer.epoch_seconds) / fsteps
    exported = np.load(poses)
    losses = {k: float(v) for k, v in ftrainer.last_losses.items()}
    print(f"[ngp] fit (SNARF_NGP_fitting at its defaults: w_lpips 0.01, "
          f"random VGG trunk): {fsteps} steps, "
          f"{res['fit_ms_per_step']:.2f} ms/step, the whole CLI "
          f"{res['fit_cli_s']:.1f} s; exported "
          f"{exported['body_pose'].shape[0]} frames to poses/train.npz; "
          f"last step: loss {losses['loss']:.5f}, "
          f"loss_lpips {losses.get('loss_lpips', float('nan')):.3e}, "
          f"loss_depth_reg {losses.get('loss_depth_reg', float('nan')):.3e}, "
          f"drift_transl {losses['drift_transl']:.3e}")
    check(exported["body_pose"].shape == (CLI_TRAIN, 69)
          and exported["transl"].shape == (CLI_TRAIN, 3),
          "fit did not export every frame")
    check(all(math.isfinite(v) for v in losses.values()),
          "fit's losses are not finite")
    check("loss_depth_reg" in losses and "loss_lpips" in losses,
          "fit did not log loss_depth_reg and loss_lpips")

    # -- animate ----------------------------------------------------------
    del ftrainer, fstate
    calls, anim_x, stop = _count_encode()
    with knn_path("ngp_animate"):
        anim = _encode_counted(lambda: animate.main(
            ["--config-name", "SNARF_NGP",
             f"+pose_sequence={work / 'poses.npz'}", "+render_downscale=2",
             *over]), paths, "ngp_animate")
    stop()
    res["animate_ms_per_frame"] = 1e3 * anim["render_s"] / anim["frames"]
    res["animate_png_ms_per_frame"] = 1e3 * anim["png_s"] / anim["frames"]
    res["animate_encode_rows"] = sum(r for r, _ in calls) / anim["frames"]
    res["animate_encode_max_rows"] = max(r for r, _ in calls)
    print(f"[ngp] animate: {anim['frames']} frames at 540px, "
          f"{res['animate_ms_per_frame']:.2f} ms/frame to host memory, PNG "
          f"write {res['animate_png_ms_per_frame']:.2f} ms/frame; alpha "
          f"coverage {min(anim['alpha_coverage']):.3f}-"
          f"{max(anim['alpha_coverage']):.3f}; hash_encode "
          f"{len(calls) / anim['frames']:.1f} calls and "
          f"{res['animate_encode_rows']:.0f} points per frame, the largest "
          f"call {res['animate_encode_max_rows']} points")
    check(anim["frames"] == CLI_POSES and anim["nonfinite_frames"] == 0,
          "NGP animate: non-finite or missing frames")
    check(all(0.02 < c < 0.95 for c in anim["alpha_coverage"]),
          f"NGP animate: implausible alpha coverage {anim['alpha_coverage']}")

    # -- the encode, timed at the paths' rows -----------------------------
    enc = encode_timing(dev, {"train_step_call": train_x["x"],
                              "animate_frame_call": anim_x["x"]})
    t = enc["train_step_call"]
    per_row_fwd = t["fwd_kernel_ms"] / t["rows"]
    per_row_fb = t["fwd_bwd_kernel_ms"] / t["rows"]
    te = res["train_encode"]
    step_enc = (per_row_fb * te["grad_rows"]
                + per_row_fwd * (te["rows"] - te["grad_rows"])) / steps
    a = enc["animate_frame_call"]
    frame_enc = a["fwd_kernel_ms"] / a["rows"] * res["animate_encode_rows"]
    res["encode"] = enc
    res["encode_ms_per_step"] = step_enc
    res["encode_ms_per_frame"] = frame_enc
    print(f"[encode] estimated share: {step_enc:.2f} ms of the "
          f"{res['ms_per_step']:.2f} ms train step "
          f"({100 * step_enc / res['ms_per_step']:.1f}%: the steps' encode "
          f"points at the per-point times of the largest call), "
          f"{frame_enc:.2f} ms of the "
          f"{res['animate_ms_per_frame']:.2f} ms animate frame "
          f"({100 * frame_enc / res['animate_ms_per_frame']:.1f}%)")

    # -- the NGP golden ---------------------------------------------------
    gold = ngp_golden.render_golden(dev)
    res["golden_db"] = gold["psnr"]
    print(f"[ngp golden] {gold['image_hw']}px NGP frame, port on "
          f"{torch.cuda.get_device_name(0)} vs JAX on CPU: rgb PSNR "
          f"{gold['psnr']:.1f} dB (bound {NGP_GOLDEN_MIN_DB}), max|alpha "
          f"diff| {np.abs(gold['alpha'] - gold['golden_alpha']).max():.3e}")
    check(gold["psnr"] >= NGP_GOLDEN_MIN_DB, "the NGP golden frame disagrees")
    res["encode_paths"] = _encode_paths_checked("ngp", paths)
    return res


def _encode_paths_checked(tag: str, paths: dict) -> dict:
    """Print each path's hash-encode kernel launches and points per
    launch; every path must have launched it."""
    for path, (launches, rows) in paths.items():
        print(f"[{tag}] {path}: hash-encode kernel launches {launches}, "
              f"points per launch {rows / max(launches, 1):.0f}")
        check(launches > 0, f"{path} never launched the hash-encode kernel")
    return paths


def knn_bound(M: int, V: int) -> tuple[float, str]:
    """Least time (ms) of ``nearest_vertex`` on M points against V
    vertices, and what sets it: 8 fp32 operations per (point, vertex)
    pair (the 3-term dot, the |x|^2 - 2 x.v + |v|^2 expansion, the min)
    at the fp32 peak, or 12 B in per point and per vertex and 12 B out
    (distance, index) per point at the HBM rate."""
    t_ops = 8.0 * M * V / FP32_FLOP_PER_S
    t_bytes = (12.0 * (M + V) + 12.0 * M) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def warp_bound(M: int, V: int, backward: bool) -> float:
    """Least time (ms) of ``nearest_warp`` on M samples against V
    vertices, by bytes at the HBM rate: per sample the index (8 B) and
    the point (12 B) read and xc (12 B) written; with the backward also
    the gradient on xc read and the points' gradient written (12 B each)
    and per vertex its 48 B of rows read twice and its 64 B of gradient
    written. Its operations (~30 fp32 a sample) take ~100 times less."""
    nbytes = (32.0 + (44.0 if backward else 0.0)) * M \
        + (48.0 + (112.0 if backward else 0.0)) * V
    return 1e3 * nbytes / HBM_BYTES_PER_S


# the 7,008-vertex toy body (SMPL's 6,890 are license-gated)
FIT_BODY = {"ring_size": 16, "bone_rings": 18}


def fit_step_model(dev, frames: int = 4, size: int = 540):
    """The demo's first command (``SNARF_NGP_fitting`` with
    ``deformer=smpl``, as ``config/build.py`` builds it) at the size a
    user runs it, from the port alone: the 7,008-vertex toy body, trained
    on ``frames`` capsule frames of that body at ``size`` px (focal
    ``size``, 3 m away, in the true poses), a fresh field. Returns (model, state,
    steps): ``steps(first, k)`` gives k steps' batches of the conf's 4 x
    32^2 patch rays, stacked on ``dev``, and their draws."""
    import warnings
    from unittest import mock
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.config import build as build_mod
    from instantavatar_torch.config import load_config
    from instantavatar_torch.data import (FrameDataset, PatchSampler,
                                          make_capsule_sequence)
    body = toy_smpl_model(**FIT_BODY, device=dev)
    conf = load_config(ROOT / "confs", "SNARF_NGP_fitting",
                       ["dataset=custom/video", "deformer=smpl"])
    with mock.patch.object(build_mod, "build_body_model",
                           lambda *_: body), warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the random LPIPS trunk's notice
        model = build_mod.build_avatar(conf, steps_per_epoch=frames,
                                       device=dev)
    seq = make_capsule_sequence(frames, size, size, distance=3.0,
                                **FIT_BODY, device=dev)
    smp = conf.sampler
    ds = FrameDataset(
        seq["images"], seq["masks"], seq["K"], seq["c2w"],
        seq["smpl_params"], "train", sampler=PatchSampler(
            int(smp.num_patch), int(smp.patch_size), float(smp.ratio_mask),
            rng=np.random.default_rng(0)), bg_rng=np.random.default_rng(1))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = model.init(seq["smpl_params"]["betas"], gen,
                       smpl_params=seq["smpl_params"])
    n_rays = int(smp.num_patch) * int(smp.patch_size) ** 2

    def steps(first: int, k: int):
        items = [ds[i % frames] for i in range(first, first + k)]
        batches = {key: torch.as_tensor(np.stack([np.asarray(b[key])
                                                  for b in items]),
                                        device=dev) for key in items[0]}
        return batches, model.draw_steps(gen, n_rays, first, k)
    return model, state, steps


def fit_warp_call(model, state, batches, draws):
    """One eager step of ``model``; returns (state, (T_inv, idx, pts,
    grad)): the step's warp of its rays' samples (the call whose points
    carry a gradient; an update step's grid sweep warps cells too) and
    the gradient that reaches its xc."""
    import instantavatar_torch.deformers.smpl_deformer as sd_mod
    M = batches["rays_o"][0].numel() // 3 * model.k_cap
    rec = {}
    real = sd_mod.nearest_warp

    def spy(T_inv, idx, pts):
        xc = real(T_inv, idx, pts)
        if not rec and pts.shape[0] == M and pts.requires_grad:
            rec.update(T=T_inv.detach().clone(), idx=idx.clone(),
                       pts=pts.detach().clone())
            xc.register_hook(lambda g: rec.setdefault("grad", g.clone()))
        return xc
    sd_mod.nearest_warp = spy
    try:
        state, _ = model.train_multi_step(state, batches, draws, graph=False)
    finally:
        sd_mod.nearest_warp = real
    return state, (rec["T"], rec["idx"], rec["pts"], rec["grad"])


def warp_index_select(T_inv: torch.Tensor, idx: torch.Tensor,
                      pts: torch.Tensor) -> torch.Tensor:
    """The warp with PyTorch's ``index_select`` for the gather (its
    backward is ``index_add_``'s atomics, not the sorted index backward of
    ``T_inv[idx]``): the library alternative to the kernels."""
    T = T_inv.index_select(0, idx)
    return (T[:, :3, :3] @ pts[..., None])[..., 0] + T[:, :3, 3]


def warp_timings(dev, T_inv: torch.Tensor, idx: torch.Tensor,
                 pts: torch.Tensor, g: torch.Tensor) -> dict:
    """Phase 13's nearest-warp timings at a fit step's own warp call
    (``fit_warp_call``: its table, indices and points, and the gradient
    that reached xc): ``nearest_warp`` (on the card the kernels of
    ``csrc/nearest_vertex.cu``) beside its plain version
    ``nearest_warp_ref`` (the gather ``T_inv[idx]``, a batched matmul and
    PyTorch's sorted index backward) and ``warp_index_select`` (the same
    with ``index_select``). The forward, and the forward with both
    gradients, in turns (kernel, plain, index_select, index_select,
    plain, kernel), median of 30 (CUDA events); the kernels' own launches
    per call (their counter: torch.profiler may miss a ctypes launch);
    the bound by bytes; the largest difference from the plain version;
    and, reckoned from the indices outside the timed calls, the share of
    the lanes with a gradient whose sum a run of their warp merges into
    another lane's atomics."""
    from instantavatar_torch.kernels import nearest_warp_cuda
    from instantavatar_torch.ops import nearest_warp_ref
    T_inv, pts, g = (t.detach().contiguous() for t in (T_inv, pts, g))
    M, V = pts.shape[0], T_inv.shape[0]
    adds = g.ne(0).any(-1)
    warp = torch.arange(M, device=dev) // 32
    runs = torch.unique((warp * V + idx)[adds]).numel()
    merged = 1.0 - runs / max(int(adds.sum()), 1)
    T_leaf = T_inv.clone().requires_grad_()
    x_leaf = pts.clone().requires_grad_()
    paths = {"kernel": nearest_warp_cuda, "plain": nearest_warp_ref,
             "index_select": warp_index_select}

    def fwd(fn):
        with torch.no_grad():
            return fn(T_inv, idx, pts)

    def fwd_bwd(fn):
        xc = fn(T_leaf, idx, x_leaf)
        return (xc, *torch.autograd.grad(xc, (T_leaf, x_leaf), g))
    got, want = fwd_bwd(nearest_warp_cuda), fwd_bwd(nearest_warp_ref)
    fwd_err = float((got[0] - want[0]).abs().max())
    fwd_bits = int((got[0].view(torch.int32)
                    != want[0].view(torch.int32)).sum())
    rel = [float((a - b).double().norm() / b.double().norm())
           for a, b in zip(got[1:], want[1:])]
    check(fwd_err <= 1e-6 and max(rel) <= 1e-5,
          f"nearest_warp at the fit's call: xc {fwd_err:.3e} from the plain "
          f"version, gradients {rel}")
    out = {"points": M, "verts": V, "adds": int(adds.sum()),
           "merged_share": merged, "fwd_max_abs_err": fwd_err,
           "fwd_bits_differ": fwd_bits, "grad_T_rel": rel[0],
           "grad_pts_rel": rel[1]}
    for call, run in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        bound = warp_bound(M, V, call == "fwd_bwd")
        ms = {path: [] for path in paths}
        for path in (*paths, *reversed(paths)):
            fn = paths[path]
            for _ in range(3):
                run(fn)
            ms[path] += cuda_ms(lambda: run(fn), 15)
        for path, fn in paths.items():
            before = nearest_warp_cuda.launches
            run(fn)
            own = nearest_warp_cuda.launches - before
            med = statistics.median(ms[path])
            out[f"{call}_{path}"] = {"ms": med, "kernel_launches": own}
            print(f"[warp] nearest_warp {call} ({path}): {M} samples x {V} "
                  f"vertices: {med:.4f} ms (median of 30 in turns, CUDA "
                  f"events), {own} launches of the kernels (their "
                  f"counter), bound {bound:.4f} ms by bytes, "
                  f"{100 * bound / med:.1f}% of it")
        out[f"{call}_bound_ms"] = bound
    check((out["fwd_kernel"]["kernel_launches"],
           out["fwd_bwd_kernel"]["kernel_launches"]) == (1, 2),
          "nearest_warp did not launch its forward and backward kernels")
    print(f"[warp] nearest_warp at the fit's call: {int(adds.sum())} of {M} "
          f"samples with a gradient, {100 * merged:.1f}% of them merged into "
          f"another lane's atomics by a run of their warp; xc max|diff| "
          f"{fwd_err:.3e} ({fwd_bits} elements not bit-equal), gradients "
          f"L2-relative {rel[0]:.3e} (table) / {rel[1]:.3e} (points) from "
          f"the plain version")
    return out


def count_flops(fn) -> float:
    """FLOPs of one call of ``fn`` (its matmuls and convolutions, forward
    and backward, as torch.utils.flop_counter counts them: 2 per
    multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def op_timings(dev, fit_x: torch.Tensor, lpips_shape, grid_size: int
               ) -> dict:
    """Phase 13's op timings: ``nearest_vertex`` (on the card the kernel,
    ``csrc/nearest_vertex.cu``; XLA in the JAX package) beside its plain
    chunked version ``nearest_vertex_ref``, at the largest deform call of
    a fit step and at the ``grid_size``^3 cells of a grid update, against
    the CLIs' 192-vertex toy body and a 7,008-vertex toy body (SMPL's
    width: 6,890), the kernel held bit-equal to the plain version first;
    and the LPIPS VGG trunk forward and forward plus backward on the fit
    step's patch stack; median of 15 (CUDA events), device launches per
    call, the kernel's own launches per call (its counter), bound."""
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SMPLDeformer
    from instantavatar_torch.kernels import nearest_vertex_cuda
    from instantavatar_torch.losses import load_lpips
    from instantavatar_torch.ops import nearest_vertex, nearest_vertex_ref
    out = {}
    g = np.random.default_rng(5)
    pose = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
        np.zeros((1, 10)), 0.2 * g.standard_normal((1, 69)),
        np.zeros((1, 3)), np.array([[0.0, 0.15, 3.0]]))]
    G = grid_size
    idx = (torch.arange(G, device=dev) + 0.5) / G
    cells = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1) \
        .reshape(-1, 3) * 2.5 - 1.25
    for body_name, body in (
            ("toy192", toy_smpl_model(device=dev)),
            ("toy7008", toy_smpl_model(ring_size=16, bone_rings=18,
                                       device=dev))):
        d = SMPLDeformer(body)
        verts = d.prepare(d.build_canonical(pose[0]), *pose).verts_smpl \
            .detach()
        for call, x in (("fit_step_call", fit_x), ("grid_cells", cells)):
            M, V = x.shape[0], verts.shape[0]
            x = x.detach().contiguous()
            # the plain version on whole chunks: a chunk of a few rows
            # rounds x.v otherwise (ops/knn.py)
            padded = torch.cat([x, x.new_zeros(((-M) % 8192, 3))])
            want = [t[:M] for t in nearest_vertex_ref(padded, verts)]
            got = nearest_vertex(x, verts)
            check(torch.equal(got[0].view(torch.int32),
                              want[0].view(torch.int32))
                  and torch.equal(got[1], want[1]),
                  f"nearest_vertex {body_name} {call}: the kernel is not "
                  f"bit-equal to the plain version")
            bound, by = knn_bound(M, V)
            key = f"{body_name}_{call}"
            out[key] = {"points": M, "verts": V, "bound_ms": bound,
                        "bound_by": by}
            for path, fn in (("kernel", lambda: nearest_vertex(x, verts)),
                             ("plain", lambda: nearest_vertex_ref(x, verts))):
                for _ in range(3):
                    fn()
                ms = statistics.median(cuda_ms(fn, 15))
                launches = device_launches(fn)
                before = nearest_vertex_cuda.launches
                fn()
                own = nearest_vertex_cuda.launches - before
                out[key][path] = {"ms": ms, "launches": launches,
                                  "kernel_launches": own}
                print(f"[knn] nearest_vertex {key} ({path}): {M} points x "
                      f"{V} vertices: {ms:.4f} ms (median of 15, CUDA "
                      f"events), {launches} device launches per call "
                      f"(torch.profiler), {own} of the kernel (its counter), "
                      f"bound {bound:.4f} ms set by {by}, "
                      f"{100 * bound / ms:.1f}% of it")
            check(out[key]["kernel"]["kernel_launches"] == 1,
                  f"nearest_vertex {key} did not launch the kernel once")
    mod = load_lpips("vgg", allow_random=True, device=dev)
    a = torch.rand(lpips_shape, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(1))
    b = torch.rand(lpips_shape, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(2))
    p = a.clone().requires_grad_()

    def fwd():
        with torch.no_grad():
            mod(a, b)

    def fwd_bwd():
        p.grad = None
        mod(p, b).sum().backward()
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        for _ in range(3):
            fn()
        ms = statistics.median(cuda_ms(fn, 15))
        # the trunk's weights and both images read once; the taps and the
        # (N,) distances are negligible beside them
        flops = count_flops(fn)
        nbytes = 4.0 * (sum(t.numel() for t in mod.buffers())
                        + 2 * a.numel())
        t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        bound = 1e3 * max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        out[f"lpips_{name}"] = {"shape": list(lpips_shape), "ms": ms,
                                "launches": device_launches(fn),
                                "bound_ms": bound, "bound_by": by,
                                "gflop": flops / 1e9}
        print(f"[lpips] VGG {name} on a {tuple(lpips_shape)} patch stack: "
              f"{ms:.4f} ms (median of 15, CUDA events, TF32 off), "
              f"{out[f'lpips_{name}']['launches']} device launches per call, "
              f"{flops / 1e9:.3f} GFLOP, bound {bound:.4f} ms set by {by} "
              f"(fp32 peak), {100 * bound / ms:.1f}% of it")
    return out


def romp_start(gt: dict, seed: int) -> dict:
    """The ground-truth poses as a ROMP estimate would leave them: transl,
    global_orient and body_pose perturbed by REFINE_SIGMA (seeded)."""
    rng = np.random.default_rng(seed)
    out = {k: np.asarray(v, np.float32) for k, v in gt.items()}
    for k in ("transl", "global_orient", "body_pose"):
        out[k] = (out[k] + REFINE_SIGMA * rng.standard_normal(out[k].shape)
                  ).astype(np.float32)
    return out


def body_keypoints(body, params: dict, K: np.ndarray):
    """Projected BODY25 keypoints (N, 25, 3: x, y, conf 1 on the body's
    slots, 0 elsewhere) of ``params`` on ``body``, and the slots."""
    from instantavatar_torch.body import smpl_forward
    from instantavatar_torch.body.extra_joints import body25_keypoints_or_core
    dev = body.v_template.device
    with torch.no_grad():
        out = smpl_forward(body, *(torch.as_tensor(
            np.asarray(params[k], np.float32), device=dev) for k in (
            "betas", "body_pose", "global_orient", "transl")))
        j, slots = body25_keypoints_or_core(out.joints, out.vertices)
    p = j.double().cpu().numpy() @ K.T
    kp = np.zeros((p.shape[0], 25, 3), np.float32)
    kp[:, slots, :2] = p[..., :2] / p[..., 2:3]
    kp[:, slots, 2] = 1.0
    return kp, slots


def keypoint_px(body, params: dict, K: np.ndarray, kp: np.ndarray) -> float:
    """Mean reprojection error (px) of ``params``' keypoints against
    ``kp`` over the slots with confidence."""
    got, slots = body_keypoints(body, params, K)
    return float(np.linalg.norm(got[:, slots, :2] - kp[:, slots, :2],
                                axis=-1).mean())


def transl_err(params: dict, gt: dict) -> float:
    return float(np.abs(params["transl"] - gt["transl"]).mean())


def preprocess_phase(dev, work: Path, seq: Path) -> dict:
    """Phase 13, preprocessing: ``seq`` made to look like a preprocessed
    video (the CLIs' toy body written as ``SMPL_NEUTRAL.npz``, ROMP-like
    ``thetas`` poses, OpenPose-like keypoints from the ground truth, the
    sequence's masks), then ``python -m
    instantavatar_torch.preprocess.process_sequence`` as a subprocess on
    the card: only refine (``--silhouette``) and the overlay run. The
    overlay stage reads the model from its default path relative to the
    working directory, as JAX's orchestrator has it, so the subprocess
    runs in ``work`` with the model under ``work/data/SMPLX/smpl``."""
    from instantavatar_torch.body import load_smpl_model
    from instantavatar_torch.body.toy import write_toy_smpl_npz
    models = work / "data" / "SMPLX" / "smpl"
    models.mkdir(parents=True, exist_ok=True)
    write_toy_smpl_npz(models / "SMPL_NEUTRAL.npz")
    body = load_smpl_model(models, device=dev)
    gt = dict(np.load(seq / "poses.npz"))
    K = np.load(seq / "cameras.npz")["intrinsic"]
    kp, slots = body_keypoints(body, gt, K)
    np.save(seq / "keypoints.npy", kp)
    start = romp_start(gt, REFINE_SEED)
    np.savez(seq / "poses.npz", betas=start["betas"], transl=start["transl"],
             thetas=np.concatenate([start["global_orient"],
                                    start["body_pose"]], axis=-1))
    n = len(list((seq / "images").glob("*.png")))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "instantavatar_torch.preprocess."
         "process_sequence", "--data-dir", str(seq), "--smpl-path",
         str(models)], cwd=work, env=env, capture_output=True, text=True,
        timeout=PREPROCESS_TIMEOUT)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.startswith("+ ") or " stage: " in line:
            print(f"[preprocess] {line}")
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n",
              file=sys.stderr)
    check(proc.returncode == 0, f"process_sequence exited {proc.returncode}")
    stages = [line.split()[3] for line in proc.stdout.splitlines()
              if line.startswith("+ ")]
    check(stages == ["instantavatar_torch.preprocess.refine_smpl",
                     "instantavatar_torch.preprocess.visualize_smpl"],
          f"process_sequence ran {stages}, not refine and the overlay alone")
    ms = {m[1]: float(m[2]) for m in re.finditer(
        r"\[refine\] (kp|sil) stage: \d+ iterations in [\d.]+ s "
        r"\(([\d.]+) ms/iteration, cuda\)", proc.stdout)}
    check(set(ms) == {"kp", "sil"},
          "refine did not run both stages on cuda")
    opt = dict(np.load(seq / "poses_optimized.npz"))
    overlays = len(list((seq / "smpl_overlay").glob("*.png")))
    res = {"wall_s": wall, "kp_ms_per_iter": ms["kp"],
           "sil_ms_per_iter": ms["sil"],
           "kp_px": (keypoint_px(body, start, K, kp),
                     keypoint_px(body, opt, K, kp)),
           "transl_m": (transl_err(start, gt), transl_err(opt, gt)),
           "overlays": overlays, "frames": n}
    print(f"[preprocess] process_sequence on {torch.cuda.get_device_name(0)}"
          f": {n} frames, {len(slots)} keypoint slots, the whole subprocess "
          f"{wall:.1f} s; refine {ms['kp']:.3f} ms per keypoint iteration, "
          f"{ms['sil']:.3f} ms per silhouette iteration (stage wall / "
          f"iterations, the first included); keypoint error "
          f"{res['kp_px'][0]:.3f} -> {res['kp_px'][1]:.3f} px, transl error "
          f"{res['transl_m'][0]:.5f} -> {res['transl_m'][1]:.5f} m; "
          f"body_pose[:, 60:] zero: {not opt['body_pose'][:, 60:].any()}; "
          f"{overlays} overlays")
    check(res["transl_m"][1] < 0.5 * res["transl_m"][0],
          "refine did not halve the transl error")
    check(res["kp_px"][1] < res["kp_px"][0],
          "refine did not reduce the keypoint error")
    check(not opt["body_pose"][:, 60:].any(), "body_pose[:, 60:] is not 0")
    check(overlays == n, f"{overlays} overlays for {n} frames")
    return res


def refine_full_phase(dev) -> dict:
    """Phase 13, the full-width refine: REFINE_FRAMES frames of the
    synthetic motion on the 7,008-vertex toy body (all 25 BODY25 slots),
    REFINE_SIZE px capsule masks traced on the card from the ground-truth
    body, ROMP-like start, ``refine`` at the script's defaults (200
    keypoint + 100 silhouette iterations); ms per iteration per stage,
    peak memory, errors before and after."""
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.data import make_capsule_sequence
    from instantavatar_torch.preprocess import refine_smpl
    from instantavatar_torch.preprocess.masks import contour_samples
    n, S = REFINE_FRAMES, REFINE_SIZE
    t0 = time.perf_counter()
    seq = make_capsule_sequence(n_frames=n, H=S, W=S, ring_size=16,
                                bone_rings=18, device=dev)
    mask_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    contours = np.stack([contour_samples(m) for m in seq["masks"]])
    contour_s = time.perf_counter() - t0
    body = toy_smpl_model(ring_size=16, bone_rings=18, device=dev)
    gt, K = seq["smpl_params"], seq["K"]
    kp, slots = body_keypoints(body, gt, K)
    check(body.num_verts == 7008 and len(slots) == 25,
          "the full-width body does not take the 25-slot BODY25 path")
    start = romp_start(gt, REFINE_SEED + 1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    refined, secs = refine_smpl.refine(
        body, {k: t(start[k]) for k in refine_smpl.KEYS}, t(K), t(kp),
        iters=REFINE_ITERS, contours=t(contours),
        sil_iters=REFINE_SIL_ITERS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    opt = {k: v.cpu().numpy() for k, v in refined.items()}
    res = {"kp_ms_per_iter": 1e3 * secs["kp"] / REFINE_ITERS,
           "sil_ms_per_iter": 1e3 * secs["sil"] / REFINE_SIL_ITERS,
           "peak_mib": peak,
           "kp_px": (keypoint_px(body, start, K, kp),
                     keypoint_px(body, opt, K, kp)),
           "transl_m": (transl_err(start, gt), transl_err(opt, gt))}
    print(f"[refine full] {n} frames, {body.num_verts} vertices "
          f"(25 BODY25 slots), {S} px capsule masks traced on the card in "
          f"{mask_s:.1f} s, contours on the host {contour_s:.1f} s; on "
          f"{torch.cuda.get_device_name(0)}: {res['kp_ms_per_iter']:.3f} ms "
          f"per keypoint iteration, {res['sil_ms_per_iter']:.3f} ms per "
          f"silhouette iteration (stage wall / iterations, the first "
          f"included), peak memory {peak:.1f} MiB; keypoint error "
          f"{res['kp_px'][0]:.3f} -> {res['kp_px'][1]:.3f} px, transl error "
          f"{res['transl_m'][0]:.5f} -> {res['transl_m'][1]:.5f} m")
    # one warm iteration of each stage: wall, device kernels and their time
    p = {k: t(start[k]).requires_grad_() for k in refine_smpl.KEYS}
    adam = torch.optim.Adam(p.values(), lr=1e-2)
    Kt, kpt, ct = t(K), t(kp), t(contours)
    losses = {"kp": lambda: refine_smpl.keypoint_loss(body, p, Kt, kpt, 0.1),
              "sil": lambda: refine_smpl.silhouette_loss(body, p, Kt, ct)
              + refine_smpl.keypoint_loss(body, p, Kt, kpt, 0.1)}
    for name, loss_fn in losses.items():
        def step(loss_fn=loss_fn):
            adam.zero_grad(set_to_none=True)
            loss_fn().backward()
            adam.step()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        warm = 1e2 * (time.perf_counter() - t0)
        launches, busy, ranked = device_busy(step)
        res[f"{name}_warm_ms"], res[f"{name}_launches"] = warm, launches
        res[f"{name}_device_ms"] = busy
        print(f"[refine full] a warm {name} iteration: {warm:.3f} ms wall "
              f"(mean of 10), {launches} device kernels running {busy:.3f} "
              f"ms in all (torch.profiler), {100 * busy / warm:.1f}% of the "
              f"wall; the largest: " + "; ".join(
                  f"{k[:70]} x{n} {ms:.3f} ms" for k, (n, ms) in ranked))
    check(all(np.isfinite(v).all() for v in opt.values()),
          "the full-width refine is not finite")
    check(res["transl_m"][1] < 0.5 * res["transl_m"][0],
          "the full-width refine did not halve the transl error")
    check(res["kp_px"][1] < res["kp_px"][0],
          "the full-width refine did not reduce the keypoint error")
    return res


def demo_phase(dev, work: Path) -> dict:
    """Phase 13: the in-the-wild demo (bash/run-neuman-demo.sh) in
    process on a copy of phase 11's sequence as ``dataset=custom/video``:
    fit with the SMPL deformer, train / novel_view / animate with the
    demo conf (smpl_init), animate at 67 px; then the op timings, the
    SMPL-deformer golden and one SMPL-deformer frame with the voxel
    triplane field (the fused head). Returns the numbers and, for the
    kernel line, the head's launches and rows on that frame."""
    import shutil
    from instantavatar_torch.cli import animate, fit, novel_view, train
    from instantavatar_torch.utils.image_io import read_png
    sys.path.insert(0, str(ROOT / "tools"))
    import make_torch_smpl_golden as smpl_golden   # numpy + the port only
    seq = work / "seq_demo"
    shutil.copytree(work / "seq", seq)
    data = ["dataset=custom/video"]
    res = {"preprocess": preprocess_phase(dev, work, seq)}

    # -- fit ------------------------------------------------------------------
    import instantavatar_torch.deformers.smpl_deformer as sd_mod
    calls, fit_x, stop = _record_calls(
        sd_mod, "nearest_vertex",
        lambda pts, verts, *_: ((pts.shape[0], verts.shape[0]), pts),
        steps_only=True)
    t0 = time.perf_counter()
    enc_paths = {}   # the encode kernel's (launches, rows) per path
    with knn_path("demo_fit"):
        ftr, fstate, poses = _encode_counted(lambda: fit.main(
            ["--config-name", "SNARF_NGP_fitting", *data, "deformer=smpl",
             f"train.max_epochs={FIT_EPOCHS}",
             *cli_overrides(seq, work / "demo_fit")]), enc_paths, "demo_fit")
    torch.cuda.synchronize()
    stop()
    res["fit_cli_s"] = time.perf_counter() - t0
    fsteps = FIT_EPOCHS * CLI_TRAIN
    res["fit_ms_per_step"] = 1e3 * sum(ftr.epoch_seconds) / fsteps
    res["fit_knn_calls"] = len(calls) / fsteps
    exported = np.load(poses)
    losses = {k: float(v) for k, v in ftr.last_losses.items()}
    sp0 = ftr.dm.trainset.get_smpl_params()
    refined = np.load(seq / "poses_optimized.npz")
    check(all(np.array_equal(sp0[k], refined[k] if k == "betas"
                             else refined[k][:CLI_TRAIN]) for k in sp0),
          "demo fit did not start from poses_optimized.npz")
    drift = max(float(np.abs(exported[k] - sp0[k]).max())
                for k in ("betas", "global_orient", "body_pose", "transl"))
    print(f"[demo] fit (SNARF_NGP_fitting dataset=custom/video deformer=smpl, "
          f"conf defaults: w_lpips 0.01 random VGG trunk, w_depth_reg 0.01, "
          f"SMPL lr 1e-4): {fsteps} steps, {res['fit_ms_per_step']:.2f} "
          f"ms/step, the whole CLI {res['fit_cli_s']:.1f} s; nearest_vertex "
          f"{res['fit_knn_calls']:.1f} calls per step, the largest "
          f"{fit_x['x'].shape[0]} points; last step: loss "
          f"{losses['loss']:.5f}, loss_lpips "
          f"{losses.get('loss_lpips', float('nan')):.4e}, loss_depth_reg "
          f"{losses.get('loss_depth_reg', float('nan')):.4e}; the exported "
          f"SMPL parameters moved by up to {drift:.3e}")
    check(type(ftr.avatar.deformer).__name__ == "SMPLDeformer",
          "fit deformer=smpl did not build the SMPL deformer")
    check(exported["body_pose"].shape == (CLI_TRAIN, 69)
          and exported["betas"].shape == (1, 10),
          "demo fit did not export every frame")
    check(all(math.isfinite(v) for v in losses.values())
          and "loss_lpips" in losses and "loss_depth_reg" in losses,
          "demo fit: loss_lpips / loss_depth_reg missing or not finite")
    check(drift > 0, "demo fit did not move the SMPL parameters")
    warps = WARP_PATHS["demo_fit"]
    check(warps[2] > 0 and warps[0] >= 2 * fsteps,
          f"demo fit: {warps[0]} launches of the warp kernels in {fsteps} "
          f"steps ({warps[2]} deform calls on the card); every step "
          f"launches a forward and a backward")

    # -- train with the demo conf -------------------------------------------
    del ftr, fstate   # the fit's model, and its graphs' memory, go with it
    run = work / "demo_run"
    over = [*data, *cli_overrides(seq, run)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with knn_path("demo_train"):
        trainer, state = _encode_counted(lambda: train.main(
            ["--config-name", "demo", "sampler.dilate=8",
             f"train.max_epochs={CLI_EPOCHS}",
             f"train.check_val_every_n_epoch={CLI_EPOCHS}", *over]),
            enc_paths, "demo_train")
    torch.cuda.synchronize()
    res["train_cli_s"] = time.perf_counter() - t0
    steps = CLI_EPOCHS * CLI_TRAIN
    res["ms_per_step"] = 1e3 * sum(trainer.epoch_seconds) / steps
    res["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    occ = state.grid.occupancy
    fracs = occ.reshape(occ.shape[0], -1).float().mean(-1).cpu()
    seeded = trainer.init_state().grid
    held = all(torch.equal(a, b) for a, b in zip(state.grid, seeded))
    val_psnr = [json.loads(line)["value"] for line in
                (run / "tensorboard" / "scalars.jsonl").read_text()
                .splitlines() if '"val/psnr"' in line][-1]
    gt = torch.as_tensor(trainer.dm.valset[0]["rgb"])
    white_db = psnr(torch.ones_like(gt), gt)
    res.update(val_psnr=val_psnr, white_psnr=white_db,
               occupied_frac=[float(f) for f in fracs])
    print(f"[demo] train (--config-name demo dataset=custom/video "
          f"sampler.dilate=8, smpl_init): {steps} steps, "
          f"{res['ms_per_step']:.2f} ms/step (a grid update every step); by "
          f"epoch {[round(1e3 * s / CLI_TRAIN, 1) for s in trainer.epoch_seconds]}"
          f" ms/step; peak memory {res['peak_mib']:.1f} MiB; the whole CLI "
          f"{res['train_cli_s']:.1f} s; per-frame grids {tuple(occ.shape)}, "
          f"occupied {float(fracs.min()):.4f}-{float(fracs.max()):.4f} of "
          f"the cells, the seeded stack held: {held}; val PSNR "
          f"{val_psnr:.2f} dB (an all-white frame: {white_db:.2f} dB)")
    G = trainer.avatar.grid_size
    check(tuple(occ.shape) == (CLI_TRAIN, G, G, G),
          f"demo grids have shape {tuple(occ.shape)}")
    check(bool(((fracs > 0) & (fracs < 0.5)).all()),
          "a demo frame's grid is empty or more than half occupied")
    check(held, "the 500-step latch did not hold the seeded grids")
    check(val_psnr > white_db, "demo val PSNR does not beat an all-white frame")

    # -- novel_view and animate at 540 px, animate at 67 px --------------------
    demo = ["--config-name", "demo"]
    pose_file = f"+pose_sequence={work / 'poses.npz'}"
    for tag, cli, frames, ds, extra in (
            ("novel_view", novel_view, CLI_TURNTABLE, 2,
             [f"+n_frames={CLI_TURNTABLE}"]),
            ("animation", animate, CLI_POSES, 2, [pose_file]),
            ("animation", animate, CLI_POSES, 16, [pose_file])):
        side = animate.make_camera(ds)[0]
        with knn_path(f"demo_{tag}_{side}px"):
            out = cli.main([*demo, f"+render_downscale={ds}", *extra, *over])
        key = f"{tag}_{side}px_ms_per_frame"
        res[key] = 1e3 * out["render_s"] / out["frames"]
        check(out["frames"] == frames and out["nonfinite_frames"] == 0,
              f"demo {tag} at {side} px: non-finite or missing frames")
        check(all(0.002 < c < 0.95 for c in out["alpha_coverage"]),
              f"demo {tag} at {side} px: implausible alpha coverage "
              f"{out['alpha_coverage']}")
        png = read_png(run / tag / f"{frames - 1:04d}.png")
        check(png.shape == (side, side, 4), f"demo {tag}: {png.shape}")
        print(f"[demo] {tag} (--config-name demo): {frames} frames at "
              f"{side}px, {res[key]:.2f} ms/frame rendered to host memory; "
              f"alpha coverage {min(out['alpha_coverage']):.3f}-"
              f"{max(out['alpha_coverage']):.3f}")

    # -- op timings -------------------------------------------------------------
    res["ops"] = op_timings(dev, fit_x["x"], (4, 32, 32, 3),
                            trainer.avatar.grid_size)
    del trainer, state
    model, mstate, steps = fit_step_model(dev)
    res["ops"]["warp"] = warp_timings(
        dev, *fit_warp_call(model, mstate, *steps(0, 1))[1])
    del model, mstate, steps

    # -- the SMPL-deformer golden ---------------------------------------------
    with knn_path("smpl_golden"):
        gold = smpl_golden.render_golden(dev)
    res["golden_db"] = gold["psnr"]
    print(f"[smpl golden] {gold['image_hw']}px SMPLDeformer + NGPField "
          f"frame, port on {torch.cuda.get_device_name(0)} vs JAX on CPU: "
          f"rgb PSNR {gold['psnr']:.1f} dB (bound {GOLDEN_MIN_DB}), "
          f"max|alpha diff| "
          f"{np.abs(gold['alpha'] - gold['golden_alpha']).max():.3e}")
    check(gold["psnr"] >= GOLDEN_MIN_DB, "the SMPL golden frame disagrees")

    # -- one SMPL-deformer frame through the fused head ------------------------
    from instantavatar_torch import convert
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.data.rays import make_ray_basis
    from instantavatar_torch.deformers import SMPLDeformer
    from instantavatar_torch.models import VoxelTriplaneField
    from instantavatar_torch.train import AvatarModel
    body = toy_smpl_model(bone_rings=3, device=dev)
    field = VoxelTriplaneField(voxel_res=64, plane_res=256, device=dev)
    field.load_state_dict(convert.field_params_from_numpy(
        convert.seeded_field_params(64, 256, 0, sigma_bias=100.0)))
    av = AvatarModel(body, field, SMPLDeformer(body, threshold=0.05),
                     grid_size=64, eval_grid="smpl_shell", shell_margin=0.08)
    st = av.init(np.zeros(10, np.float32))
    K = np.array([[2000.0, 0, W / 2], [0, 2000.0, H / 2], [0, 0, 1]])
    batch = {"ray_basis": make_ray_basis(K, np.eye(4)),
             "betas": np.zeros(10, np.float32),
             "body_pose": np.zeros(69, np.float32),
             "global_orient": np.array([0.0, 0.5, 0.0], np.float32),
             "transl": np.array([0.0, 0.15, 5.0], np.float32)}
    av.render_frame(st, batch, image_shape=(H, W))    # warm
    t0 = time.perf_counter()
    with knn_path("smpl_voxel_frame"):
        out, launches, rows = _counted(
            lambda: av.render_frame(st, batch, image_shape=(H, W)))
    res["smpl_voxel_frame_ms"] = (time.perf_counter() - t0) * 1e3
    cover = float(out["alpha"].mean())
    print(f"[demo] SMPL-deformer frame, network=voxel_triplane, {H}px: "
          f"{res['smpl_voxel_frame_ms']:.2f} ms (shell grid and bake "
          f"included), alpha coverage {cover:.3f}, fused-head launches "
          f"{launches}, rows per launch {rows / max(launches, 1):.0f}")
    check(launches > 0, "the SMPL-deformer frame never launched the CUDA head")
    check(bool(torch.isfinite(out["rgb"]).all()) and 0.01 < cover < 0.95,
          "the SMPL-deformer voxel-triplane frame is not plausible")
    res["paths"] = {"smpl_voxel_frame": (launches, rows)}
    res["encode_paths"] = _encode_paths_checked("demo", enc_paths)
    return res


def data_phase(dev, work: Path) -> dict:
    """Phase 14, data: phase 11's CLI train for one epoch on the Python
    path (``+dataset.opt.native=false``); the train split's batches timed
    warm on both paths, in turns; then a ``MocapDataset`` train split
    (its default EdgeSampler) on the same sequence feeding MOCAP_STEPS
    ``AvatarModel.step`` calls of the flagship configuration (phase 7's)."""
    from instantavatar_torch.cli import train
    from instantavatar_torch.data import (AvatarDataset, MocapDataset,
                                          PatchSampler)
    seq = work / "seq"
    res = {}
    t0 = time.perf_counter()
    trainer, _ = train.main(
        ["--config-name", "SNARF_NGP", "train.max_epochs=1",
         "train.check_val_every_n_epoch=1", *cli_overrides(seq, work / "py"),
         "network=voxel_triplane", "+dataset.opt.native=false"])
    torch.cuda.synchronize()
    check(not trainer.dm.trainset.native_active,
          "dataset.opt.native=false did not keep the Python path")
    res["py_ms_per_step"] = 1e3 * sum(trainer.epoch_seconds) / CLI_TRAIN
    res["py_batch_ms"] = 1e3 * trainer.batch_seconds / CLI_TRAIN
    print(f"[data] train CLI, 1 epoch with +dataset.opt.native=false: "
          f"{res['py_ms_per_step']:.2f} ms/step, batch assembly "
          f"{res['py_batch_ms']:.2f} ms/step of host time (this first epoch "
          f"decodes each PNG once, with read_png); the whole CLI "
          f"{time.perf_counter() - t0:.1f} s")

    # the conf's PatchSampler (4 x 32^2, ratio_mask 1), both paths warm
    kw = dict(start=0, end=CLI_TRAIN - 1)
    nat = AvatarDataset(seq, "train", native=True,
                        sampler=PatchSampler(4, 32, 1.0), **kw)
    py = AvatarDataset(seq, "train", sampler=PatchSampler(4, 32, 1.0), **kw)
    check(nat.native_active, "the native engine did not build")
    for i in range(CLI_TRAIN):
        py[i]                                   # decode once
    ms = {"native": [], "python": []}
    for _ in range(2):
        for name, ds in (("native", nat), ("python", py)):
            t0 = time.perf_counter()
            for i in range(CLI_TRAIN):
                ds[i]
            ms[name].append(1e3 * (time.perf_counter() - t0) / CLI_TRAIN)
    res["native_item_ms"] = statistics.median(ms["native"])
    res["python_item_ms"] = statistics.median(ms["python"])
    res["decode_ms"] = 1e3 * nat.native_cache.decode_seconds
    print(f"[data] a train batch (4 x 32^2 patches), warm, median of 2 "
          f"passes over {CLI_TRAIN} frames in turns: native engine "
          f"{res['native_item_ms']:.3f} ms, Python path "
          f"{res['python_item_ms']:.3f} ms; the engine's decode of the "
          f"sequence (read_png) {res['decode_ms']:.1f} ms")

    mocap = MocapDataset(seq, "train", bg_rng=np.random.default_rng(3), **kw)
    mocap.sampler.rng = np.random.default_rng(4)
    avatar = make_trainer(dev, steps_per_epoch=CLI_TRAIN)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = avatar.init(mocap.smpl_params["betas"], generator=gen)
    times, mse = [], []
    for i in range(MOCAP_STEPS):
        batch = mocap[i % CLI_TRAIN]
        t0 = time.perf_counter()
        state, losses = avatar.step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check(all(math.isfinite(float(v)) for v in losses.values()),
              f"MocapDataset step {i}: a loss is not finite")
        mse.append(float(losses["mse_loss"]))
    res["mocap_ms_per_step"] = statistics.median(times[1:])
    first, last = statistics.mean(mse[:5]), statistics.mean(mse[-5:])
    print(f"[data] MocapDataset (EdgeSampler({mocap.sampler.num_mask} + "
          f"{mocap.sampler.num_edge} + {mocap.sampler.num_rand} rays, kernel "
          f"32)) -> {MOCAP_STEPS} AvatarModel.step calls of the flagship "
          f"configuration: median {res['mocap_ms_per_step']:.2f} ms/step "
          f"(first step, with the grid update, {times[0]:.1f} ms); mse_loss "
          f"mean of the first 5 steps {first:.5f}, of the last 5 {last:.5f}")
    check(mocap[0]["rgb"].shape == (4096, 3), "MocapDataset batch shape")
    check(last < first, "the MocapDataset run's loss did not fall")
    return res


def triplane_phase(dev, work: Path) -> dict:
    """Phase 14, the triplane field: ``train network=triplane`` (three
    32 x 256^2 fp32 planes, the fp32 head) on phase 11's sequence for
    TRIPLANE_EPOCHS epochs with a validation render."""
    from instantavatar_torch.cli import train
    run = work / "triplane_run"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, state = train.main(
        ["--config-name", "SNARF_NGP", f"train.max_epochs={TRIPLANE_EPOCHS}",
         f"train.check_val_every_n_epoch={TRIPLANE_EPOCHS}",
         *cli_overrides(work / "seq", run), "network=triplane"])
    torch.cuda.synchronize()
    field = trainer.avatar.field
    check(type(field).__name__ == "TriPlaneField"
          and tuple(field.plane_xy.shape) == (32, 256, 256),
          "network=triplane did not build the full-width TriPlaneField")
    steps = TRIPLANE_EPOCHS * CLI_TRAIN
    check(state.step == steps, f"triplane train took {state.step} steps")
    res = {"ms_per_step": 1e3 * sum(trainer.epoch_seconds) / steps,
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    val_psnr = [json.loads(line)["value"] for line in
                (run / "tensorboard" / "scalars.jsonl").read_text()
                .splitlines() if '"val/psnr"' in line][-1]
    gt = torch.as_tensor(trainer.dm.valset[0]["rgb"])
    white_db = psnr(torch.ones_like(gt), gt)
    res["val_psnr"], res["white_psnr"] = val_psnr, white_db
    print(f"[triplane] train network=triplane (3 x 32 x 256^2 planes, fp32 "
          f"head): {steps} steps, {res['ms_per_step']:.2f} ms/step; by epoch "
          f"{[round(1e3 * s / CLI_TRAIN, 1) for s in trainer.epoch_seconds]}"
          f" ms/step; peak memory {res['peak_mib']:.1f} MiB; the whole CLI "
          f"{time.perf_counter() - t0:.1f} s; val PSNR {val_psnr:.2f} dB (an "
          f"all-white frame: {white_db:.2f} dB)")
    check(val_psnr > white_db,
          "triplane val PSNR does not beat an all-white frame")
    return res


def modes_batch(dev) -> dict:
    """Phases 14 and 19's 540 px frame: the pinhole basis and the
    per-pixel rays (on the card) of one camera, a turned pose."""
    from instantavatar_torch.data.rays import make_ray_basis, make_ray_grid
    K = np.array([[2000.0, 0, W / 2], [0, 2000.0, H / 2], [0, 0, 1]])
    ro, rd = make_ray_grid(K, np.eye(4), H, W)
    return {"ray_basis": make_ray_basis(K, np.eye(4)),
            "rays_o": torch.as_tensor(ro.reshape(-1, 3), device=dev),
            "rays_d": torch.as_tensor(rd.reshape(-1, 3), device=dev),
            "betas": np.zeros(10, np.float32),
            "body_pose": np.zeros(69, np.float32),
            "global_orient": np.array([0.0, 0.5, 0.0], np.float32),
            "transl": np.array([0.0, 0.15, 5.0], np.float32)}


def mode_avatar(avatar, mode: str):
    """A model on phase 4's body, field and deformer with phase 4's
    render knobs and eval mode ``mode``'s (``EVAL_MODES``)."""
    from instantavatar_torch.train import AvatarModel
    return AvatarModel(avatar.body, avatar.field, avatar.deformer,
                       **{**AVATAR_540_KW, "grid_size": avatar.grid_size,
                          "shell_margin": avatar.shell_margin},
                       **EVAL_MODES[mode])


def modes_phase(dev, avatar, state, grid) -> dict:
    """Phase 14, the eval modes: one 540 px frame of phase 4's avatar,
    state and shell grid in each of EVAL_MODES (a model per mode on the
    same body, field and deformer; the frame carries per-pixel rays for
    the ray-bundle modes). Per mode: warm ms/frame (the second frame of a
    session: the bake reused, as on the turntable), the head's launches
    and rows, rgb PSNR against the flat and the dense frame, and, as in
    phase 5, against the same mode rendered (and baked) with the plain
    head in the kernel's place."""
    from instantavatar_torch.kernels import fused_field_head_ref
    from instantavatar_torch.train import RenderSession
    batch = modes_batch(dev)
    res, rgbs = {}, {}
    for mode in EVAL_MODES:
        av = mode_avatar(avatar, mode)
        sess = RenderSession()
        for _ in range(2):   # the budgets learned, the graph captured
            av.render_frame(state, batch, grid=grid, image_shape=(H, W),
                            session=sess)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches, rows = _counted(lambda: av.render_frame(
            state, batch, grid=grid, image_shape=(H, W), session=sess))
        ms = 1e3 * (time.perf_counter() - t0)
        cover = float(out["alpha"].mean())
        check(bool(torch.isfinite(out["rgb"]).all()) and 0.05 < cover < 0.95,
              f"mode {mode}: non-finite or implausible frame ({cover:.3f})")
        check(launches > 0, f"mode {mode} never launched the CUDA head")
        avatar.field.head_fn = fused_field_head_ref
        try:
            plain = av.render_frame(state, batch, grid=grid,
                                    image_shape=(H, W))
        finally:
            avatar.field.head_fn = None
        rgbs[mode] = out["rgb"]
        res[mode] = {"ms": ms, "launches": launches, "rows": rows,
                     "samples": out["n_samples"], "alpha": cover,
                     "swap_db": psnr(out["rgb"], plain["rgb"])}
    for mode, r in res.items():
        r["db_vs_flat"] = psnr(rgbs[mode], rgbs["flat"])
        r["db_vs_dense"] = psnr(rgbs[mode], rgbs["dense"])
        print(f"[modes] {mode}: {r['ms']:.2f} ms/frame warm at {H}px, "
              f"{r['samples']} samples, alpha coverage {r['alpha']:.3f}, "
              f"head launches {r['launches']}, rows {r['rows']}; rgb PSNR "
              f"vs flat {r['db_vs_flat']:.2f} dB, vs dense "
              f"{r['db_vs_dense']:.2f} dB, vs its plain-head render "
              f"{r['swap_db']:.2f} dB (bound {HEAD_SWAP_MIN_DB})")
        check(r["swap_db"] >= HEAD_SWAP_MIN_DB,
              f"mode {mode}: the head swap changed the frame")
        for ref, floor in zip(("flat", "dense"), MODE_MIN_DB[mode]):
            check(floor is None or r[f"db_vs_{ref}"] >= floor,
                  f"mode {mode}: PSNR against the {ref} frame below its "
                  f"floor {floor} dB")
    return res


# -- phase 15: the parallel layer ------------------------------------------

def _rank_device(name: str) -> torch.device:
    """A spawned rank's device, with TF32 off as in the parent."""
    dev = torch.device(name)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _flat_params(avatar) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1)
                      for p in avatar.field.parameters()]).cpu()


def _dp_train_rank(rank: int, world: int, work: str) -> None:
    """Phase 15 rank: ``dp_train_in.pt``'s steps of phase 7's flagship
    configuration over the ray group of gloo ranks (the first a grid
    update), from the parent's checkpoint, this rank's draws from
    ``rank_draws``, eagerly (a gloo group cannot be captured). Writes the
    first step's losses and grid, the last parameters, the step times,
    the bytes reduced per step, and the head's launches and rows of the
    run, and the plain step's bucket all-reduced alone."""
    import torch.distributed as dist
    from instantavatar_torch.kernels import fused_field_head
    from instantavatar_torch.parallel import (make_dp_train_step, make_mesh,
                                              rank_draws)
    from instantavatar_torch.train.harness import restore_checkpoint
    work = Path(work)
    inp = torch.load(work / "dp_train_in.pt", weights_only=False)
    dev = _rank_device(inp["device"])
    avatar = make_trainer(dev, **inp["trainer_kw"])
    state = restore_checkpoint(inp["ckpt"], avatar.init(inp["betas"]),
                               avatar.field)
    mesh = make_mesh(n_ray=world)
    steps = {u: make_dp_train_step(avatar, mesh, u) for u in (False, True)}
    n_params = sum(p.numel() for p in avatar.field.parameters())
    out = {"ms": [], "bytes": [], "update": []}
    fused_field_head.launches = fused_field_head.rows = 0
    for i, batch in enumerate(inp["batches"]):
        update = state.step % avatar.grid_update_interval == 0
        n_loc = int(np.prod(batch["rays_o"].shape[:-1])) // world
        draws = rank_draws(avatar, mesh, DP_SEED + i, n_loc, update)
        _sync(dev)
        t0 = time.perf_counter()
        state, losses = steps[update](state, batch, draws)
        _sync(dev)
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["update"].append(update)
        out["bytes"].append(4 * (n_params + len(losses) + (
            2 * state.grid.occupancy.numel() if update else 0)))
        if i == 0:
            out["losses0"] = {k: float(v) for k, v in losses.items()}
            out["occupancy0"] = state.grid.occupancy.cpu()
            out["density0"] = state.grid.density_cached.cpu()
    out["params"] = _flat_params(avatar)
    out["launches"], out["rows"] = (fused_field_head.launches,
                                    fused_field_head.rows)
    bucket = torch.zeros(out["bytes"][1] // 4, device=dev)
    ms = []
    for i in range(7):
        _sync(dev)
        t0 = time.perf_counter()
        dist.all_reduce(bucket, group=mesh.group)
        _sync(dev)
        if i >= 2:
            ms.append(1e3 * (time.perf_counter() - t0))
    out["all_reduce_ms"] = statistics.median(ms)
    torch.save(out, work / f"dp_train_gloo_{rank}.pt")


def _dp_render_rank(rank: int, world: int, work: str) -> None:
    """Phase 15 rank: phase 4's avatar (the parent's canonical bake and
    grid) renders its band of ``dp_render_in.pt``'s turntable in each
    layout, a warm frame first, then the turntable with one new session;
    rank 0 writes the gathered frames. Every rank writes its head launches
    and rows per layout, and the gather of a frame's bands timed alone."""
    import torch.distributed as dist
    from instantavatar_torch.kernels import fused_field_head
    from instantavatar_torch.parallel import DPFrameRenderer, make_mesh
    from instantavatar_torch.train import RenderSession, TrainState
    work = Path(work)
    inp = torch.load(work / "dp_render_in.pt", weights_only=False)
    dev = _rank_device(inp["device"])
    avatar = make_avatar(dev, **inp["avatar_kw"])
    state = TrainState(deformer_cano=inp["cano"], grid=None,
                       center=inp["center"], scale=inp["scale"])
    grid, shape, frames = inp["grid"], inp["image_shape"], inp["frames"]
    mesh = make_mesh(n_ray=world)
    out = {}
    for layout in ("stride", "band"):
        rend = DPFrameRenderer(avatar, mesh, layout=layout)
        rend.render_frame(state, frames[0], grid=grid, image_shape=shape,
                          session=RenderSession())
        _sync(dev)
        fused_field_head.launches = fused_field_head.rows = 0
        t0 = time.perf_counter()
        outs = list(rend.render_frames(state, frames, grid=grid,
                                       image_shape=shape,
                                       session=RenderSession()))
        _sync(dev)
        out[layout] = {
            "ms": 1e3 * (time.perf_counter() - t0) / len(frames),
            "launches": fused_field_head.launches,
            "rows": fused_field_head.rows,
            "bands_baked": [o["bands_baked"] for o in outs],
            "rgb": [o["rgb"].cpu() for o in outs] if rank == 0 else None}
    n_loc = shape[0] * shape[1] // world
    local = torch.zeros((n_loc + 1, 6), device=dev)
    full = local.new_empty((world * (n_loc + 1), 6))
    ms = []
    for i in range(13):
        _sync(dev)
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(full, local, group=mesh.group)
        _sync(dev)
        if i >= 3:
            ms.append(1e3 * (time.perf_counter() - t0))
    out["gather_ms"] = statistics.median(ms)
    torch.save(out, work / f"dp_render_{rank}.pt")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _load_ranks(work: Path, prefix: str, world: int) -> list[dict]:
    return [torch.load(work / f"{prefix}_{r}.pt", map_location="cpu",
                       weights_only=False) for r in range(world)]


def _dp_inputs(dev, work: Path, *, size=TRAIN_SIZE, n_train=TRAIN_FRAMES,
               **config) -> dict:
    """Phases 15.1 and 18.1's inputs: phase 7's configuration
    (``config``: ``make_trainer``'s sizes), a checkpoint of its state 0
    and DP_STEPS batches, written to ``dp_train_in.pt``."""
    from instantavatar_torch.train.harness import save_checkpoint
    _, train, _ = capsule_splits(dev, size, n_train, 1)
    trainer_kw = {"steps_per_epoch": n_train, **config}
    avatar = make_trainer(dev, **trainer_kw)
    betas = train.smpl_params["betas"]
    state = avatar.init(betas, generator=torch.Generator(
        device=dev).manual_seed(0))
    inp = {"device": str(dev), "trainer_kw": trainer_kw,
           "ckpt": save_checkpoint(work / "dp_ckpt", state, avatar.field),
           "betas": betas,
           "batches": [train[i % n_train] for i in range(DP_STEPS)]}
    torch.save(inp, work / "dp_train_in.pt")
    return inp


def _single_step(dev, inp: dict, world: int, deterministic: bool):
    """Step 1 of ``inp`` in one process on the whole batch, fed the
    ``world`` ranks' draws: (avatar, state, losses)."""
    from instantavatar_torch.parallel import make_mesh, rank_draws
    from instantavatar_torch.train import StepDraws
    from instantavatar_torch.train.harness import restore_checkpoint
    batch = inp["batches"][0]
    n_rays = int(np.prod(batch["rays_o"].shape[:-1]))
    ref = make_trainer(dev, **inp["trainer_kw"])
    rstate = restore_checkpoint(inp["ckpt"], ref.init(inp["betas"]),
                                ref.field)
    mesh = make_mesh(n_ray=world)
    parts = [rank_draws(ref, mesh, DP_SEED, n_rays // world, True, ray=r)
             for r in range(world)]
    draws = StepDraws(torch.cat([d.jitter for d in parts]),
                      torch.cat([d.noise for d in parts]),
                      parts[0].grid_jitter)
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        rstate, rl = ref.train_step_update(rstate, batch, draws)
    finally:
        torch.use_deterministic_algorithms(False)
    return ref, rstate, rl


def dp_train_check(dev, work: Path, **config) -> dict:
    """Phase 15.1: DP_STEPS training steps of phase 7's configuration
    (``config``: ``_dp_inputs``'s sizes) on DP_RANKS gloo ranks sharing
    the card, eagerly (gloo cannot be captured), the first step held
    against the single-process step. Returns the run's head launches and
    rows. The one-NCCL-rank run is phase 18.1's."""
    from instantavatar_torch.parallel import run_ranks
    inp = _dp_inputs(dev, work, **config)
    n_rays = int(np.prod(inp["batches"][0]["rays_o"].shape[:-1]))
    secs = run_ranks(_dp_train_rank, DP_RANKS, backend="gloo",
                     store_dir=work, args=(str(work),),
                     timeout=SPAWN_TIMEOUT, threads=torch.get_num_threads())
    ranks = _load_ranks(work, "dp_train_gloo", DP_RANKS)
    _, rstate, rl = _single_step(dev, inp, DP_RANKS, False)
    rl = {k: float(v) for k, v in rl.items()}
    r0 = ranks[0]
    gap = max(abs(r0["losses0"][k] / rl[k] - 1.0) for k in
              ("mse_loss", "loss_alpha", "reg_alpha", "reg_occupancy",
               "loss"))
    occ_ok = torch.equal(r0["occupancy0"], rstate.grid.occupancy.cpu())
    dens = float((r0["density0"]
                  - rstate.grid.density_cached.cpu()).abs().max())
    # step 0 is cold
    plain = [m for m, u in zip(r0["ms"][1:], r0["update"][1:]) if not u]
    upd = [m for m, u in zip(r0["ms"][1:], r0["update"][1:]) if u]
    print(f"[dp train] gloo: {DP_RANKS} ranks on "
          f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else dev}"
          f", eager (a gloo group cannot be captured), {DP_STEPS} steps "
          f"of phase 7's configuration ({n_rays // DP_RANKS} rays per "
          f"rank): median {statistics.median(plain):.2f} ms per plain "
          f"step, {statistics.median(upd or [math.nan]):.2f} ms per warm "
          f"grid-update step, the cold first {r0['ms'][0]:.0f} ms; "
          f"{r0['bytes'][1] / 2 ** 20:.2f} MiB reduced per plain step "
          f"({r0['bytes'][0] / 2 ** 20:.2f} with the grid), its "
          f"all_reduce alone {r0['all_reduce_ms']:.2f} ms (median of "
          f"5); the ranks ran {secs:.1f} s with start-up")
    print(f"[dp train] gloo: step 1 against the single-process step on "
          f"the whole batch with the ranks' draws: worst loss gap "
          f"{gap:.2e} (tol {DP_LOSS_RTOL}), grid occupancy equal "
          f"{occ_ok}, density max|diff| {dens:.3e}")
    check(occ_ok and dens == 0.0, "gloo: the DP grid update differs")
    check(gap <= DP_LOSS_RTOL, "gloo: DP losses disagree")
    same = all(torch.equal(r["params"], r0["params"]) for r in ranks[1:])
    print(f"[dp train] gloo: parameters bit-identical on the {DP_RANKS} "
          f"ranks after {DP_STEPS} steps: {same}; two ranks share one "
          f"card here, so the step time is no scaling number")
    check(same, "the DP ranks' parameters drifted apart")
    launches = sum(r["launches"] for r in ranks)
    check(dev.type != "cuda" or launches > 0,
          "dp_train_gloo never launched the CUDA head")
    return {"dp_train_gloo": (launches, sum(r["rows"] for r in ranks))}


def dp_render_check(dev, avatar, state, grid, batch, work: Path) -> dict:
    """Phase 15.2 and 15.3: phase 4's 540 px turntable over DP_RANKS gloo
    ranks in both layouts against the single-device frames, then one
    band's program alone for each of DP_BAND_LAYOUTS. Returns the paths'
    head launches and rows, and the timings."""
    from instantavatar_torch.parallel import (DPFrameRenderer, make_mesh,
                                              run_ranks)
    from instantavatar_torch.train import RenderSession
    frames = [{**batch, "global_orient": np.array(
        [0.0, 2 * np.pi * i / DP_TURNTABLE, 0.0], np.float32)}
        for i in range(DP_TURNTABLE)]
    torch.save({"device": str(dev), "avatar_kw": SLICE_AVATAR_ARGS,
                "cano": state.deformer_cano, "center": state.center,
                "scale": state.scale, "grid": grid, "image_shape": (H, W),
                "frames": frames}, work / "dp_render_in.pt")
    secs = run_ranks(_dp_render_rank, DP_RANKS, backend="gloo",
                     store_dir=work, args=(str(work),),
                     timeout=SPAWN_TIMEOUT)
    ranks = _load_ranks(work, "dp_render", DP_RANKS)
    singles = [avatar.render_frame(state, f, grid=grid, image_shape=(H, W),
                                   session=RenderSession())["rgb"].cpu()
               for f in frames]
    paths, res = {}, {"gather_ms": ranks[0]["gather_ms"]}
    for layout in ("stride", "band"):
        r0 = ranks[0][layout]
        dbs = [psnr(a, b) for a, b in zip(r0["rgb"], singles)]
        err = max(float((a - b).abs().max())
                  for a, b in zip(r0["rgb"], singles))
        baked = r0["bands_baked"]
        per_rank = [r[layout]["launches"] for r in ranks]
        print(f"[dp render] {layout}: {DP_RANKS} gloo ranks, {H} px "
              f"turntable of {DP_TURNTABLE}: {r0['ms']:.2f} ms/frame "
              f"(bake, band, gather; two ranks share the card); PSNR "
              f"against the single-device frames {[round(d, 2) for d in dbs]}"
              f" dB (bound {DP_MIN_DB}), max|rgb diff| {err:.3e}; bands that "
              f"baked per frame {baked}; head launches per rank {per_rank}")
        check(min(dbs) >= DP_MIN_DB, f"{layout}: DP frame below its floor")
        check(baked[0] == DP_RANKS and sum(baked[1:]) == 0,
              f"{layout}: the bake memo did not engage over the turntable")
        check(dev.type != "cuda" or all(n > 0 for n in per_rank),
              f"{layout}: a rank never launched the CUDA head")
        paths[f"dp_render_{layout}"] = (
            sum(per_rank), sum(r[layout]["rows"] for r in ranks))
    print(f"[dp render] the gather of a {H} px frame's {DP_RANKS} bands "
          f"(all_gather_into_tensor over gloo, through the host): "
          f"{res['gather_ms']:.3f} ms (median of 10); the ranks ran "
          f"{secs:.1f} s with start-up")

    def bands():
        sess = RenderSession()
        avatar.render_frame(state, batch, grid=grid, image_shape=(H, W),
                            session=sess)
        dstate = avatar._prepare(state.deformer_cano, batch)
        bake = []
        for _ in range(3):
            _sync(dev)
            t0 = time.perf_counter()
            avatar._bake(state, dstate, grid, avatar._new_tables())
            _sync(dev)
            bake.append(1e3 * (time.perf_counter() - t0))
        res["bake_ms"] = statistics.median(bake)
        for layout, R in DP_BAND_LAYOUTS:
            # as tools/dp_overhead_bench.py: rows padded to split into R
            # bands of 3-row blocks (540 -> 552 at R = 8), the padding
            # charged to the bands
            Hp = H
            while Hp % R or (Hp // R) % 3:
                Hp += 1
            rend = DPFrameRenderer(avatar, make_mesh(n_ray=R), layout=layout)
            rend.render_band(state, batch, 0, grid=grid, image_shape=(Hp, W),
                             session=sess)
            ms = []
            for c in range(R):
                t = []
                for _ in range(3):
                    _sync(dev)
                    t0 = time.perf_counter()
                    rend.render_band(state, batch, c, grid=grid,
                                     image_shape=(Hp, W), session=sess)
                    _sync(dev)
                    t.append(1e3 * (time.perf_counter() - t0))
                ms.append(statistics.median(t))
            res[f"band_{layout}_{R}"] = ms
            print(f"[dp band] {layout} R={R} ({Hp} x {W} px): ms per band "
                  f"{[round(m, 2) for m in ms]}, busiest {max(ms):.2f}, "
                  f"mean {statistics.mean(ms):.2f}; an R-card frame "
                  f"~ busiest band + gather {max(ms) + res['gather_ms']:.2f} "
                  f"ms (+ the replicated bake {res['bake_ms']:.2f} ms on a "
                  f"new pose); one card's frame: phase 4")
    _, *paths["dp_band_programs"] = _counted(bands)
    return {"paths": paths, **res}


def multi_phase(dev, work: Path, cli: dict) -> dict:
    """Phase 15.4: ``train_multi`` on two copies of phase 11's sequence
    (one card, the subjects stepped in turn) for MULTI_EPOCHS epochs;
    each subject's checkpoint through ``animate``."""
    import shutil

    from instantavatar_torch.cli import animate, train_multi
    root, run = work / "multi", work / "multi_run"
    for s in MULTI_SUBJECTS:
        shutil.copytree(work / "seq", root / s)
    over = cli_overrides(f"{root}/${{dataset.subject}}",
                         f"{run}/${{dataset.subject}}")
    args = ["--config-name", "SNARF_NGP",
            f"+subjects={','.join(MULTI_SUBJECTS)}",
            f"train.max_epochs={MULTI_EPOCHS}", "network=voxel_triplane",
            *over]
    out, *paths = _counted(lambda: train_multi.main(args))
    ms = out[0]["ms_per_step"]
    check([o["subject"] for o in out] == list(MULTI_SUBJECTS)
          and all(o["state"].step == MULTI_EPOCHS * CLI_TRAIN for o in out),
          "train_multi did not train every subject")
    print(f"[multi] train_multi, {len(out)} subjects on one card, "
          f"{MULTI_EPOCHS} epochs, each combined step {len(out)} graph "
          f"replays (one per subject's model, the CLI's default on CUDA; "
          f"the captures included): {ms:.2f} ms per combined step "
          f"({ms / len(out):.2f} per subject; phase 11's single-subject "
          f"CLI: {cli['ms_per_step']:.2f} ms/step)")
    res = {"paths": {"train_multi": tuple(paths)}, "ms_per_step": ms}
    for s in MULTI_SUBJECTS:
        a, *p = _counted(lambda: animate.main(
            ["--config-name", "SNARF_NGP",
             f"+pose_sequence={work / 'poses.npz'}", "+render_downscale=2",
             "network=voxel_triplane",
             *cli_overrides(root / s, run / s)]))
        check(a["frames"] == CLI_POSES and a["nonfinite_frames"] == 0,
              f"animate of subject {s}'s checkpoint failed")
        res["paths"][f"train_multi_animate_{s}"] = tuple(p)
        print(f"[multi] subject {s}: its checkpoint through animate, "
              f"{a['frames']} frames, alpha coverage "
              f"{min(a['alpha_coverage']):.3f}-{max(a['alpha_coverage']):.3f}")
    return res



# -- phase 16: the captured step against the eager one ---------------------

# host calls that start device work (kernels, graphs, copies)
LAUNCH_APIS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
    "cudaMemsetAsync"})


def _step_tensors(avatar, state, losses: dict) -> list[torch.Tensor]:
    """What a training step leaves: parameters, Adam moments, counts, the
    grid, the SMPL leaves and the step's losses (copies)."""
    opt = state.opt_state
    out = [p.detach() for p in avatar.field.parameters()]
    for group in ("field", "smpl"):
        mom = opt.moments(group)
        out += (mom[0] + mom[1]) if mom else []
    out += [opt.count, opt.notfinite_count, *state.grid]
    out += [p.detach() for p in state.smpl or ()]
    out += [losses[k] for k in sorted(losses)]
    return [t.clone() for t in out]


def _gap(a: list, b: list) -> float:
    """Largest absolute difference over the tensors of two runs."""
    return max(float((x.double() - y.double()).abs().max())
               if x.numel() else 0.0 for x, y in zip(a, b, strict=True))


def _run_steps(avatar, make_state, batches: list, graph: bool) -> list:
    """``len(batches)`` steps from ``make_state()`` with a generator
    seeded GRAPH_SEED: eager ``step`` calls, or ``train_multi_step`` on
    groups of GRAPH_GROUP (the Trainer's default)."""
    from instantavatar_torch.train.harness import iterate_grouped
    dev = avatar.device
    state = make_state()
    gen = torch.Generator(device=dev).manual_seed(GRAPH_SEED)
    if graph:
        for host in iterate_grouped(batches.__getitem__, range(len(batches)),
                                    GRAPH_GROUP):
            n = len(host["rays_o"])
            state, losses = avatar.train_multi_step(
                state, {k: torch.as_tensor(v).to(dev)
                        for k, v in host.items()},
                avatar.draw_steps(gen, int(np.prod(host["rays_o"]
                                                   .shape[1:-1])),
                                  state.step, n))
    else:
        for b in batches:
            state, losses = avatar.step(state, b, gen, graph=False)
    torch.cuda.synchronize()
    return _step_tensors(avatar, state, losses)


def _profile_step(fn) -> dict:
    """One call of ``fn`` under torch.profiler: device kernels (and
    copies), their summed ms, host launch calls, the profiled wall ms
    and the busy share; the ms of the hash-encode kernels
    (``csrc/hash_encode.cu``'s ``encode_*``) and the four kernel names
    with the most ms, each with (count, ms)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.events()
    dev_ev = [e for e in ev
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    by_name: dict[str, tuple[int, float]] = {}
    for e in dev_ev:
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return {"kernels": len(dev_ev), "busy_ms": busy, "profiled_ms": wall,
            "busy_share": busy / wall,
            "host_launches": sum(1 for e in ev if e.name in LAUNCH_APIS),
            "encode_ms": sum(ms for k, (_, ms) in by_name.items()
                             if "encode_" in k),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]}


def _timed_steps(avatar, state, batch, graph: bool, update: bool,
                 step=None) -> dict:
    """Warm ms per step (median of GRAPH_TIMED after one untimed call,
    the capture's in graph mode), peak memory over those calls, one
    profiled step; the steps sit past step 1000 (no warm-up, latch or
    noise: most of a run) at the configuration's cadence. ``step(state,
    batch, generator)`` runs one step (default ``avatar.step``)."""
    interval = avatar.grid_update_interval
    if not update and interval == 1:
        return {}
    if step is None:
        def step(st, b, gen):
            return avatar.step(st, b, gen, graph=graph)
    s0 = interval * math.ceil(1000 / interval) + (0 if update else 1)
    gen = torch.Generator(device=avatar.device).manual_seed(GRAPH_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for j in range(GRAPH_TIMED + 1):
        st = state._replace(step=s0 + j * interval)
        t0 = time.perf_counter()
        step(st, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res = {"ms": statistics.median(times[1:]),
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    res.update(_profile_step(lambda: step(state._replace(step=s0), batch,
                                          gen)))
    return res


def _timing_line(tag: str, kind: str, t: dict, per: str = "step",
                 reps: int | None = None) -> str:
    return (f"{tag} {kind}: {t['ms']:.2f} ms/{per} (median of "
            f"{reps or GRAPH_TIMED}, warm); one profiled {per}: "
            f"{t['kernels']} "
            f"device kernels and copies, busy {t['busy_ms']:.2f} of "
            f"{t['profiled_ms']:.2f} ms (share {t['busy_share']:.3f}), "
            f"{t['host_launches']} host launch calls; peak memory "
            f"{t['peak_mib']:.1f} MiB")


def graph_check(name: str, avatar, make_state, batches: list) -> dict:
    """Phase 16 for one configuration: GRAPH_STEPS steps eager and then
    on graphs (``train_multi_step``) from one state and one seed, held
    bit-equal under deterministic algorithms (or, where capture refuses
    that mode, no further apart than two eager runs in the default mode);
    then each mode timed per step kind."""
    from instantavatar_torch.kernels import fused_field_head, hash_encode_cuda
    kernels = (fused_field_head, hash_encode_cuda)
    mode = "deterministic"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager = _run_steps(avatar, make_state, batches, False)
        before = [(k.launches, k.rows) for k in kernels]
        try:
            graph = _run_steps(avatar, make_state, batches, True)
        except RuntimeError as e:
            print(f"[graph] {name}: capture refused deterministic "
                  f"algorithms ({str(e).splitlines()[0][:200]}); comparing "
                  f"in the default mode")
            mode = "default"
    finally:
        torch.use_deterministic_algorithms(False)
    if mode == "default":
        eager = _run_steps(avatar, make_state, batches, False)
        before = [(k.launches, k.rows) for k in kernels]
        graph = _run_steps(avatar, make_state, batches, True)
    head, enc = ((k.launches - n, k.rows - r)
                 for k, (n, r) in zip(kernels, before))
    gap = _gap(eager, graph)
    res = {"mode": mode, "gap": gap, "head": head, "encode": enc}
    if mode == "deterministic":
        check(gap == 0.0, f"{name}: {GRAPH_STEPS} graph steps differ from "
                          f"the eager ones by {gap:.3e} under deterministic "
                          f"algorithms")
    else:
        res["eager_gap"] = _gap(eager, _run_steps(avatar, make_state,
                                                  batches, False))
        check(gap <= res["eager_gap"], f"{name}: graph gap {gap:.3e} above "
                                       f"the eager gap {res['eager_gap']:.3e}")
    print(f"[graph] {name}: {GRAPH_STEPS} steps, eager vs train_multi_step "
          f"in groups of {GRAPH_GROUP} ({mode} algorithms): max |difference| "
          f"of parameters, Adam moments, counts, grid and last losses "
          f"{gap:.3e}"
          + (f" (eager vs eager {res['eager_gap']:.3e})" if "eager_gap" in res
             else "")
          + f"; fused-head launches in the graph run {head[0]}, "
            f"hash-encode kernel launches {enc[0]}")
    state, batch = make_state(), batches[0]
    g = avatar.step_graphs
    c0, s0 = g.captures, g.capture_seconds
    for graph_mode in (False, True):
        for update in (True, False):
            t = _timed_steps(avatar, state, batch, graph_mode, update)
            if not t:
                continue
            kind = ("graph" if graph_mode else "eager") + (
                "_update" if update else "_plain")
            res[kind] = t
            print(_timing_line(f"[graph] {name}", kind, t))
            print(f"[graph] {name} {kind}, the profiled step's device time: "
                  f"hash-encode kernels {t['encode_ms']:.2f} of "
                  f"{t['busy_ms']:.2f} ms; the largest: " + "; ".join(
                      f"{k[:70]} x{n} {ms:.2f} ms"
                      for k, (n, ms) in t["top"]))
    res["captures"], res["capture_s"] = g.captures, g.capture_seconds
    print(f"[graph] {name}: {g.captures} graphs captured in all, "
          f"{g.capture_seconds:.2f} s of capture (warm-ups included; "
          f"{g.captures - c0} and {g.capture_seconds - s0:.2f} s for the "
          f"timed steps)")
    return res


def graph_phase(dev, work: Path) -> dict:
    """Phase 16: the captured training step against the eager one, at
    full width, for the flagship (phase 7's), the NGP conf default (phase
    12's) and the demo's fit (SMPL deformer, LPIPS) and train
    (smpl_init) steps (phase 13's). Returns each one's numbers and the
    flagship graph run's head launches and rows."""
    from instantavatar_torch.config.build import build_trainer
    from instantavatar_torch.utils.cli import parse_cli
    res = {}
    seq, train, _ = capsule_splits(dev, TRAIN_SIZE, TRAIN_FRAMES, VAL_FRAMES)
    avatar = make_trainer(dev, steps_per_epoch=TRAIN_FRAMES)
    res["flagship"] = graph_check(
        "flagship", avatar,
        lambda: avatar.init(seq["smpl_params"]["betas"],
                            generator=torch.Generator(device=dev)
                            .manual_seed(0)),
        [train[i % TRAIN_FRAMES] for i in range(GRAPH_STEPS)])
    del avatar
    demo = ["dataset=custom/video"]
    for name, argv, seq_dir in (
            ("ngp", ["--config-name", "SNARF_NGP"], "seq"),
            ("demo_fit", ["--config-name", "SNARF_NGP_fitting", *demo,
                          "deformer=smpl"], "seq_demo"),
            ("demo_train", ["--config-name", "demo", *demo,
                            "sampler.dilate=8"], "seq_demo")):
        run = work / f"graph_{name}"
        tr = build_trainer(parse_cli([*argv, *cli_overrides(
            work / seq_dir, run)]), workdir=run, device=dev)
        ds = tr.dm.trainset
        res[name] = graph_check(name, tr.avatar, tr.init_state,
                                [ds[i % len(ds)] for i in range(GRAPH_STEPS)])
    for kind in ("eager_plain", "graph_plain"):
        t = res["ngp"][kind]
        print(f"[graph] ngp {kind}: {t['ms']:.2f} ms/step, peak memory "
              f"{t['peak_mib']:.1f} MiB (with the plain PyTorch encode, "
              f"PERF.md: eager 90.11 / 70.14, graphs 45.78 / 46.25 "
              f"ms/step, 8002.2 MiB on graphs)")
    res["paths"] = {"graph_vs_eager_flagship": res["flagship"]["head"]}
    res["encode_paths"] = _encode_paths_checked(
        "graph", {f"graph_{n}": res[n]["encode"]
                  for n in ("ngp", "demo_fit", "demo_train")})
    return res


# -- phase 17: the flat frame on graphs against the eager exact one --------

def _exact_frame(avatar, state, frame, grid, session) -> dict:
    """The frame eager at exact counts (``render_stream`` without budgets,
    ``torch.nonzero`` selections), its grid built per pose, eagerly, when
    ``grid`` is None (``build_pose_grid``, as ``animate`` does)."""
    g = (grid if grid is not None
         else avatar.build_pose_grid(state, frame, graph=False))
    return avatar.composite_frame(
        avatar.render_stream(state, frame, g, (H, W), session))


def _timed_frames(run, avatar, knn_as: str | None = None
                  ) -> tuple[list, float, float, tuple]:
    """FRAME_WARM untimed passes of ``run()`` (a list of frames), then one
    timed: (its frames, ms per frame, peak MiB, and in it the head's
    launches and rows, the frame graphs captured and the grid graphs
    replayed). With ``knn_as`` the timed pass's nearest-vertex launches
    go to ``KNN_PATHS[knn_as]``."""
    from instantavatar_torch.kernels import fused_field_head

    def captures():
        return avatar.frame_graphs.captures if avatar.frame_graphs else 0

    def grid_replays():
        return avatar.grid_graphs.replays if avatar.grid_graphs else 0
    for _ in range(FRAME_WARM):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, rows = fused_field_head.launches, fused_field_head.rows
    c0, r0 = captures(), grid_replays()
    with knn_path(knn_as) if knn_as else contextlib.nullcontext():
        t0 = time.perf_counter()
        outs = run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / len(outs)
    return (outs, ms, torch.cuda.max_memory_allocated() / 2 ** 20,
            (fused_field_head.launches - launches,
             fused_field_head.rows - rows, captures() - c0,
             grid_replays() - r0))


def frame_phase(dev, avatar, state, grid, turntable: list) -> dict:
    """Phase 17: phase 4's avatar at 540 px, the 8-frame turntable (its
    shell grid) and a FRAME_POSES-pose animate sequence (each pose's own
    grid and bake), first eager at exact counts, then through
    ``render_frames`` at the session's learned budgets, each frame one
    replay of a captured graph. Per sequence and run: warm ms/frame and
    rays/s, peak memory, one profiled frame (device kernels, busy share,
    host launch calls); the graph frames against the eager ones (PSNR
    floor FRAME_MIN_DB), the head's launches on the replays, the graphs
    captured, the learned budgets against the counts; for the animate
    sequence also PR 11's form (graph frames on eager grids) beside it.
    Then a frame at priors too small for it (FRAME_TINY), which must
    re-render to the same frame, and phase 18.3 (``grid_graph_check``) on
    the animate poses. Returns the graph runs' head launches and rows."""
    from instantavatar_torch.train import RenderSession
    g = np.random.default_rng(17)
    poses = []
    for i in range(FRAME_POSES):
        bp = 0.05 * g.standard_normal(69).astype(np.float32)
        bp[47] += 0.6 * np.sin(i)
        bp[50] -= 0.6 * np.sin(i)
        poses.append({**turntable[0], "body_pose": bp, "global_orient":
                      np.array([0.0, -0.6 + 1.2 * i / (FRAME_POSES - 1),
                                0.0], np.float32)})
    res, paths = {}, {}
    for name, frames, fgrid in (("turntable", turntable, grid),
                                ("animate", poses, None)):
        eager_sess, graph_sess = RenderSession(), RenderSession()
        exact, e_ms, e_peak, _ = _timed_frames(lambda: [
            _exact_frame(avatar, state, f, fgrid, eager_sess)
            for f in frames], avatar)
        fg = avatar.frame_graphs
        c0 = (fg.captures, fg.capture_seconds) if fg else (0, 0.0)
        graphed, g_ms, g_peak, (launches, rows, timed_captures,
                                grid_replays) = \
            _timed_frames(lambda: list(avatar.render_frames(
                state, frames, grid=fgrid, image_shape=(H, W),
                session=graph_sess)), avatar, f"frame_graph_{name}")
        fg = avatar.frame_graphs
        check(fg is not None and fg.replays > 0,
              f"{name}: the frames replayed no graph")
        c1 = (fg.captures, fg.capture_seconds)
        dbs = [psnr(a["rgb"], b["rgb"]) for a, b in zip(graphed, exact)]
        err = max(float((a[k] - b[k]).abs().max()) for a, b in
                  zip(graphed, exact) for k in ("rgb", "alpha", "depth"))
        check(min(dbs) >= FRAME_MIN_DB, f"{name}: a graph frame is "
              f"{min(dbs):.2f} dB from its exact-count eager frame")
        check(launches > 0 and timed_captures == 0,
              f"{name}: the head's launches did not rise on replays "
              f"({launches}), or the timed pass captured "
              f"{timed_captures} graphs")
        # each frame's grid is one replay of a grid graph (the animate
        # poses) or the given grid (the turntable); a replay is one
        # nearest-vertex launch over the grid's cells
        knn = KNN_PATHS[f"frame_graph_{name}"]
        want = (len(frames), len(frames) * avatar.grid_size ** 3) \
            if fgrid is None else (0, 0)
        print(f"[frame] {name}: timed graph pass, {len(frames)} frames: "
              f"{grid_replays} grid-graph replays, nearest-vertex kernel "
              f"launches {knn[0]}, rows {knn[1]}")
        check(knn == want and grid_replays == want[0],
              f"{name}: the timed graph pass made {knn} nearest-vertex "
              f"(launches, rows) and {grid_replays} grid replays, not {want}: "
              f"one launch per frame's grid replay")
        f0, f1 = frames[0], frames[-1]
        prof_e = _profile_step(lambda: _exact_frame(avatar, state, f1,
                                                    fgrid, eager_sess))
        prof_g = _profile_step(lambda: avatar.render_frame(
            state, f0, grid=fgrid, image_shape=(H, W), session=graph_sess))
        runs = [("eager exact", e_ms, e_peak, prof_e)]
        if fgrid is None:
            # PR 11's animate for comparison: graph frames, eager grids
            mixed_sess = RenderSession()
            build = avatar.build_pose_grid
            avatar.build_pose_grid = lambda s, b, graph=None: build(
                s, b, graph=False)
            try:
                mixed, m_ms, m_peak, _ = _timed_frames(lambda: list(
                    avatar.render_frames(state, frames, image_shape=(H, W),
                                         session=mixed_sess)), avatar)
                prof_m = _profile_step(lambda: avatar.render_frame(
                    state, f0, image_shape=(H, W), session=mixed_sess))
            finally:
                del avatar.build_pose_grid
            mixed_db = min(psnr(a["rgb"], b["rgb"])
                           for a, b in zip(mixed, graphed))
            print(f"[frame] {name}: graph frames on graphed grids against "
                  f"those on eager grids: PSNR min {mixed_db:.2f} dB "
                  f"(bound {FRAME_MIN_DB})")
            check(mixed_db >= FRAME_MIN_DB, f"{name}: the frames on graphed "
                  f"grids differ from those on eager grids")
            runs.append(("graph frame, eager grid", m_ms, m_peak, prof_m))
        runs.append(("graph" if fgrid is not None else
                     "graph frame, graph grid", g_ms, g_peak, prof_g))
        skey = (H * W, (H, W, avatar._block_size(H, W)))
        hits = [o["n_samples"] for o in graphed]
        occ = [o["n_occ"] for o in graphed]
        r = {"eager_ms": e_ms, "graph_ms": g_ms, "eager_peak_mib": e_peak,
             "graph_peak_mib": g_peak, "min_db": min(dbs), "max_err": err,
             "eager_profile": prof_e, "graph_profile": prof_g,
             "captures": c1[0] - c0[0], "capture_s": c1[1] - c0[1],
             "samp_budget": graph_sess.samp_budget[skey],
             "cell_budget": graph_sess.cell_budget[skey],
             "kept": (min(hits), max(hits)), "occupied": (min(occ), max(occ))}
        res[name] = r
        paths[f"frame_graph_{name}"] = (launches, rows)
        for run, ms, peak, prof in runs:
            print(f"[frame] {name} {run}: {ms:.2f} ms/frame warm, "
                  f"{H * W / ms * 1e3:.0f} rays/s, peak memory {peak:.1f} "
                  f"MiB; one profiled frame: {prof['kernels']} device "
                  f"kernels and copies, busy {prof['busy_ms']:.2f} of "
                  f"{prof['profiled_ms']:.2f} ms (share "
                  f"{prof['busy_share']:.3f}), {prof['host_launches']} host "
                  f"launch calls")
        print(f"[frame] {name}: {len(frames)} frames, graph vs eager exact "
              f"PSNR min {min(dbs):.2f} dB (bound {FRAME_MIN_DB}), max "
              f"|rgb/alpha/depth diff| {err:.3e}; head launches in the "
              f"timed graph pass {launches} ({rows / max(launches, 1):.0f} "
              f"rows each); graphs captured {r['captures']} in "
              f"{r['capture_s']:.2f} s (none in the timed pass); learned "
              f"budgets: samples {r['samp_budget']} for kept "
              f"{r['kept'][0]}-{r['kept'][1]}, cells {r['cell_budget']} for "
              f"occupied {r['occupied'][0]}-{r['occupied'][1]}")
    # a forced overflow: priors too small for the samples and the cells
    spr, cells = avatar.samples_per_ray, avatar.cell_budget
    passes = []
    dispatch = avatar._dispatch_frame
    avatar._dispatch_frame = lambda rec, rebake=False: (
        passes.append(rebake), dispatch(rec, rebake))
    avatar.samples_per_ray, avatar.cell_budget = FRAME_TINY
    try:
        forced = avatar.render_frame(state, poses[2], image_shape=(H, W))
    finally:
        avatar.samples_per_ray, avatar.cell_budget = spr, cells
        del avatar._dispatch_frame
    want = _exact_frame(avatar, state, poses[2], None, RenderSession())
    db = psnr(forced["rgb"], want["rgb"])
    print(f"[frame] forced overflow at priors {FRAME_TINY}: {len(passes)} "
          f"renders (rebakes {sum(passes[1:])}), PSNR {db:.2f} dB against "
          f"the exact-count frame (bound {FRAME_MIN_DB})")
    check(len(passes) >= 2 and any(passes[1:]) and db >= FRAME_MIN_DB,
          "the forced overflow did not re-render to the same frame")
    # -- 18.3: the animate poses' grids, eager and on graphs -------------
    res["grid"] = grid_graph_check(avatar, state, poses)
    res["paths"] = {**paths, **res["grid"].pop("paths")}
    return res


# -- phase 18: JAX's last eager programs on graphs ---------------------------

def _dp_graph_rank(rank: int, world: int, work: str) -> None:
    """Phase 18.1 rank: phase 7's configuration from ``dp_train_in.pt``'s
    checkpoint on a world of one rank (NCCL on the card), the DP step
    eagerly and then on graphs: steps 1 (grid update) and 2 (plain) from
    the checkpoint under deterministic algorithms, and what each leaves;
    then each mode timed per step kind (steps past 1000, default
    algorithms). Writes those, the graphs captured, and the head's
    launches and rows in the graph runs."""
    import torch.distributed as dist
    from instantavatar_torch.kernels import fused_field_head
    from instantavatar_torch.parallel import (make_dp_train_step, make_mesh,
                                              rank_draws)
    from instantavatar_torch.train.harness import restore_checkpoint
    work = Path(work)
    inp = torch.load(work / "dp_train_in.pt", weights_only=False)
    dev = _rank_device(inp["device"])
    avatar = make_trainer(dev, **inp["trainer_kw"])
    mesh = make_mesh(n_ray=world)
    batches = inp["batches"]
    n = int(np.prod(batches[0]["rays_o"].shape[:-1])) // world
    steps: dict = {}

    def dp(graph: bool, update: bool):
        if (graph, update) not in steps:
            steps[graph, update] = make_dp_train_step(avatar, mesh, update,
                                                      graph=graph)
        return steps[graph, update]

    out = {"backend": str(dist.get_backend(mesh.group))}
    head = [0, 0]

    def counted(fn):
        l0, r0 = fused_field_head.launches, fused_field_head.rows
        res = fn()
        head[0] += fused_field_head.launches - l0
        head[1] += fused_field_head.rows - r0
        return res

    def exact_run(graph: bool) -> list:
        state = restore_checkpoint(inp["ckpt"], avatar.init(inp["betas"]),
                                   avatar.field)
        left = []
        for i in range(2):
            update = avatar.is_update(state.step)
            draws = rank_draws(avatar, mesh, DP_SEED + i, n, update)
            state, losses = dp(graph, update)(state, batches[i], draws)
            left.append([t.cpu() for t in _step_tensors(avatar, state,
                                                        losses)])
        return left, state
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out["eager"], _ = exact_run(False)
        out["graph"], state = counted(lambda: exact_run(True))
    finally:
        torch.use_deterministic_algorithms(False)
    for graph in (False, True):
        for update in (True, False):
            def step(st, b, gen, graph=graph, update=update):
                return dp(graph, update)(st, b, avatar.draw(gen, n, update))
            kind = ("graph" if graph else "eager") + (
                "_update" if update else "_plain")
            out[kind] = (counted if graph else lambda f: f())(
                lambda: _timed_steps(avatar, state, batches[2], graph,
                                     update, step))
    g = avatar.step_graphs
    out["captures"], out["capture_s"] = g.captures, g.capture_seconds
    out["launches"], out["rows"] = head
    torch.save(out, work / f"dp_graph_{rank}.pt")


def dp_graph_check(dev, work: Path) -> dict:
    """Phase 18.1: the DP step on one NCCL rank (the ``all_reduce`` real
    and, on graphs, inside the graph; NCCL puts no two ranks on one
    card), phase 15's inputs: the eager step against the single-process
    step and the graph steps against the eager ones, bit for bit at a
    grid update and a plain step (deterministic algorithms); then each
    mode timed per step kind. Returns the graph runs' head launches and
    rows, and the numbers."""
    from instantavatar_torch.parallel import run_ranks
    inp = torch.load(work / "dp_train_in.pt", weights_only=False)
    secs = run_ranks(_dp_graph_rank, 1, backend="nccl" if dev.type == "cuda"
                     else "gloo", store_dir=work, args=(str(work),),
                     timeout=SPAWN_TIMEOUT, threads=torch.get_num_threads())
    (r,) = _load_ranks(work, "dp_graph", 1)
    ref, rstate, rl = _single_step(dev, inp, 1, True)
    one = _gap(r["eager"][0], [t.cpu() for t in _step_tensors(ref, rstate,
                                                               rl)])
    gaps = [_gap(a, b) for a, b in zip(r["eager"], r["graph"], strict=True)]
    print(f"[dp graph] one {r['backend']} rank, phase 7's configuration: "
          f"the eager DP step 1 against the single-process step max|diff| "
          f"{one:.3e}; steps 1 (grid update) and 2 (plain) on graphs (the "
          f"all_reduce inside) against eager, max|diff| of parameters, "
          f"Adam moments, counts, grid and losses {gaps} (deterministic "
          f"algorithms in all); the rank ran {secs:.1f} s with start-up")
    check(one == 0.0, "the one-rank DP step differs from the "
          "single-process step")
    check(all(g == 0.0 for g in gaps), "the graphed DP step differs from "
          "the eager one")
    res = {"gaps": gaps}
    for kind in ("eager_update", "eager_plain", "graph_update",
                 "graph_plain"):
        res[kind] = r[kind]
        print(_timing_line("[dp graph]", kind, r[kind]))
    res.update(captures=r["captures"], capture_s=r["capture_s"])
    print(f"[dp graph] {r['captures']} graphs captured, "
          f"{r['capture_s']:.2f} s of capture (warm-ups included); "
          f"fused-head launches in the graph runs {r['launches']}")
    check(dev.type != "cuda" or r["launches"] > 0,
          "the graphed DP step never launched the CUDA head")
    res["paths"] = {"dp_graph_nccl": (r["launches"], r["rows"])}
    return res


def multi_graph_check(dev) -> dict:
    """Phase 18.2: ``train_multi``'s combined step (``make_multi_subject
    _step``) on two subjects of phase 7's configuration in one process,
    MULTI_GRAPH_STEPS combined steps (the first a grid update) eagerly
    and then on graphs (each subject's step one replay of its model's
    graph, the two queued back to back), from one pair of states and
    seeds, bit-equal under deterministic algorithms; then the warm
    combined plain step per mode. Returns the graph runs' head launches
    and rows, and the numbers."""
    from instantavatar_torch.kernels import fused_field_head
    from instantavatar_torch.parallel import (make_mesh,
                                              make_multi_subject_step,
                                              stack_subjects)
    from instantavatar_torch.train.harness import _to_device
    seq, train, _ = capsule_splits(dev, TRAIN_SIZE, TRAIN_FRAMES, VAL_FRAMES)
    betas = seq["smpl_params"]["betas"]
    S = len(MULTI_SUBJECTS)
    avatars = [make_trainer(dev, steps_per_epoch=TRAIN_FRAMES)
               for _ in range(S)]
    mesh = make_mesh(n_ray=1, n_subject=S)
    batches = [[_to_device(train[(i + 7 * k) % TRAIN_FRAMES], dev)
                for k in range(S)] for i in range(MULTI_GRAPH_STEPS)]
    n = int(np.prod(batches[0][0]["rays_o"].shape[:-1]))
    head = [0, 0]

    def run(graph: bool):
        subjects = stack_subjects([(av, av.init(
            betas, generator=torch.Generator(device=dev).manual_seed(k)))
            for k, av in enumerate(avatars)])
        gens = [torch.Generator(device=dev).manual_seed(GRAPH_SEED + k)
                for k in range(S)]
        steps = {u: make_multi_subject_step(mesh, u, graph=graph)
                 for u in (False, True)}
        l0, r0 = fused_field_head.launches, fused_field_head.rows
        for b in batches:
            update = avatars[0].is_update(subjects[0][1].step)
            subjects, losses = steps[update](
                subjects, b, [av.draw(g, n, update)
                              for av, g in zip(avatars, gens)])
        torch.cuda.synchronize()
        if graph:
            head[0] += fused_field_head.launches - l0
            head[1] += fused_field_head.rows - r0
        return subjects, [t.cpu() for (av, st), l in zip(subjects, losses)
                          for t in _step_tensors(av, st, l)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, eager = run(False)
        subjects, graph = run(True)
    finally:
        torch.use_deterministic_algorithms(False)
    gap = _gap(eager, graph)
    print(f"[multi graph] {S} subjects of phase 7's configuration in one "
          f"process: {MULTI_GRAPH_STEPS} combined steps (the first a grid "
          f"update) eager against graphs, each subject one replay per "
          f"step: max|diff| of both subjects' parameters, Adam moments, "
          f"counts, grids and losses {gap:.3e} (deterministic "
          f"algorithms)")
    check(gap == 0.0, "the graphed combined step differs from the eager "
          "one")
    res = {"gap": gap}
    gen = torch.Generator(device=dev).manual_seed(GRAPH_SEED)
    draws = [av.draw(gen, n, False) for av in avatars]
    for graph in (False, True):
        step = make_multi_subject_step(mesh, False, graph=graph)

        def combined():
            # step 1001: plain, no warm-up, latch or noise
            return step([(av, st._replace(step=1001))
                         for av, st in subjects], batches[1], draws)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        l0, r0 = fused_field_head.launches, fused_field_head.rows
        times = []
        for _ in range(GRAPH_TIMED + 1):
            t0 = time.perf_counter()
            combined()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        t = {"ms": statistics.median(times[1:]),
             "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
             **_profile_step(combined)}
        if graph:
            head[0] += fused_field_head.launches - l0
            head[1] += fused_field_head.rows - r0
        kind = "graph" if graph else "eager"
        res[kind] = t
        print(_timing_line("[multi graph]", kind, t, "combined step"))
    res["captures"] = sum(av.step_graphs.captures for av in avatars)
    res["capture_s"] = sum(av.step_graphs.capture_seconds for av in avatars)
    print(f"[multi graph] {res['captures']} graphs captured over the "
          f"{S} models, {res['capture_s']:.2f} s of capture (warm-ups "
          f"included); fused-head launches in the graph runs {head[0]}")
    check(head[0] > 0, "the graphed combined step never launched the head")
    res["paths"] = {"multi_graph": tuple(head)}
    return res


def grid_graph_check(avatar, state, poses: list) -> dict:
    """Phase 18.3: the per-pose grids of phase 17's animate poses
    (``build_pose_grid``, and ``build_test_grid`` on two of them) eagerly
    and on graphs: equal exactly (occupancy, density and box;
    deterministic algorithms, under which these graphs are captured),
    then warm ms per grid per mode (default algorithms, the graphs
    captured anew) and one profiled build. Returns the graphed test
    grids' head launches and rows."""
    from instantavatar_torch.kernels import fused_field_head
    res, paths = {}, {}
    for kind, build, sel in (("pose", avatar.build_pose_grid, poses),
                             ("test", avatar.build_test_grid, poses[:2])):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            eager = [build(state, f, graph=False) for f in sel]
            l0, r0 = fused_field_head.launches, fused_field_head.rows
            graphed = [build(state, f, graph=True) for f in sel]
            torch.cuda.synchronize()
            head = (fused_field_head.launches - l0,
                    fused_field_head.rows - r0)
        finally:
            torch.use_deterministic_algorithms(False)
        same = all(torch.equal(a, b) for e, g in zip(eager, graphed)
                   for a, b in zip(e, g))
        occ = [int(g.occupancy.sum()) for g in graphed]
        print(f"[grid graph] {kind} grid, {len(sel)} poses: graph equals "
              f"eager exactly (occupancy, density, box): {same}; occupied "
              f"cells {occ}")
        check(same, f"the graphed {kind} grid differs from the eager one")
        # the timed graphs anew, captured in the default mode
        avatar.grid_graphs.graphs.clear()
        for graph in (False, True):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for f in sel + sel[:1]:
                t0 = time.perf_counter()
                build(state, f, graph=graph)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            t = {"ms": statistics.median(times[1:]),
                 "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                 **_profile_step(lambda: build(state, sel[-1],
                                               graph=graph))}
            mode = "graph" if graph else "eager"
            res[f"{kind}_{mode}"] = t
            print(_timing_line("[grid graph]", f"{kind} {mode}", t, "grid",
                               len(sel)))
        if kind == "test":
            check(head[0] > 0, "the graphed test grid never launched the "
                  "head")
            paths["grid_graph_test"] = head
    gg = avatar.grid_graphs
    print(f"[grid graph] {gg.captures} grid graphs captured, "
          f"{gg.capture_seconds:.2f} s of capture (warm-ups included), "
          f"{gg.replays} replays")
    res["paths"] = paths
    return res


# -- phase 19: the ray-bundle frames and make_dp_render on graphs -----------

_FRAME_OUT = ("rgb", "depth", "alpha", "counter")


def _deterministic_pair(eager_fn, graph_fn) -> tuple[str, object, object]:
    """``eager_fn()`` and ``graph_fn()`` under PyTorch's deterministic
    algorithms, or, where a capture refuses that mode, both in the
    default mode: (mode, eager result, graph result)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager = eager_fn()
        try:
            return "deterministic", eager, graph_fn()
        except RuntimeError as e:
            print(f"[rays graph] capture refused deterministic algorithms "
                  f"({str(e).splitlines()[0][:200]}); comparing in the "
                  f"default mode")
    finally:
        torch.use_deterministic_algorithms(False)
    return "default", eager_fn(), graph_fn()


def _held(name: str, mode: str, eager: list, graphed: list) -> float:
    """Graph frames against the eager ones: bit-equal under
    deterministic algorithms, else at least FRAME_MIN_DB apart in rgb;
    returns the largest difference of rgb, depth, alpha and counter."""
    err = max(float((a[k].double() - b[k].double()).abs().max())
              for a, b in zip(eager, graphed, strict=True)
              for k in _FRAME_OUT)
    if mode == "deterministic":
        check(err == 0.0, f"{name}: the graph differs from the eager run "
                          f"by {err:.3e} under deterministic algorithms")
    else:
        db = min(psnr(a["rgb"], b["rgb"]) for a, b in zip(eager, graphed))
        check(db >= FRAME_MIN_DB, f"{name}: the graph is {db:.2f} dB from "
                                  f"the eager run")
    return err


def _timed_peak(run, reps: int = 1) -> tuple[object, dict]:
    """FRAME_WARM untimed calls of ``run`` (the captures among them), then
    ``reps`` timed, then one profiled (``_profile_step``): (the last
    timed result, ``_timing_line``'s numbers: the median ms, the peak MiB
    over the warm and timed calls, a graph's capture included)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FRAME_WARM):
        run()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    t = {"ms": statistics.median(times),
         "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    return out, {**t, **_profile_step(run)}


def rays_mode_check(avatar, state, grid, batch, mode: str) -> dict:
    """Phase 19 for one ray-bundle mode at 540 px on phase 4's avatar:
    two frames of one session (the bake, then its reuse) eagerly at the
    budgets and on graphs, held (``_held``), each also against the
    exact-count eager frame (``render_rays_frame``, PSNR floor
    FRAME_MIN_DB); then, on graphs captured anew in the default mode, the
    exact eager frame, the eager frame at the budgets (the padded rays)
    and the graph frame timed warm with their peak memory (the graph's
    capture included: at most 1.2x the exact eager frame's), one profiled
    frame each, and the captures with their seconds."""
    from instantavatar_torch.train import RenderSession
    av = mode_avatar(avatar, mode)

    def two(graph):
        sess = RenderSession()
        outs = [av.render_frame(state, batch, grid=grid, image_shape=(H, W),
                                session=sess, graph=graph)
                for _ in range(2)]
        torch.cuda.synchronize()
        return outs
    algo, eager, graphed = _deterministic_pair(lambda: two(False),
                                               lambda: two(True))
    err = _held(f"mode {mode}", algo, eager, graphed)
    exact = av.render_rays_frame(state, batch, grid, (H, W), RenderSession())
    exact_db = min(psnr(g["rgb"], exact["rgb"]) for g in graphed)
    exact_err = max(float((g[k] - exact[k]).abs().max()) for g in graphed
                    for k in _FRAME_OUT)
    check(exact_db >= FRAME_MIN_DB, f"mode {mode}: the graph frame is "
          f"{exact_db:.2f} dB from the exact-count eager frame")
    check(all(g["n_samples"] == int(exact["n_samples"]) for g in graphed),
          f"mode {mode}: the graph frame evaluated other samples than the "
          f"exact-count frame")
    # timed on graphs captured in the default mode
    av.frame_graphs = None
    sess_e, sess_b, sess_g = RenderSession(), RenderSession(), RenderSession()

    def exact_run():
        return av.render_rays_frame(state, batch, grid, (H, W), sess_e)

    def budget_run():
        return av.render_frame(state, batch, grid=grid, image_shape=(H, W),
                               session=sess_b, graph=False)

    def graph_run():
        return av.render_frame(state, batch, grid=grid, image_shape=(H, W),
                               session=sess_g)
    _, t_e = _timed_peak(exact_run)
    _, t_b = _timed_peak(budget_run)
    (_, launches, rows), t_g = _timed_peak(lambda: _counted(graph_run))
    rec = av._render_frame_async(state, batch, grid=grid, image_shape=(H, W),
                                 session=sess_g)
    av._finish_frame(rec)
    hits = rec["counts"]()[0]
    fg = av.frame_graphs
    r = {"hits": hits, "ray_budget": rec["ray_budget"],
         "algorithms": algo, "max_err": err, "exact_db": exact_db,
         "exact_err": exact_err, "eager": t_e, "budget": t_b, "graph": t_g,
         "captures": fg.captures, "capture_s": fg.capture_seconds,
         "launches": launches, "rows": rows,
         "samples": graphed[1]["n_samples"]}
    tag = f"[rays graph] {mode}"
    print(f"{tag}: graph vs eager at the budgets ({algo} algorithms, bake "
          f"and reuse frames) max |diff| {err:.3e}; vs the exact-count "
          f"eager frame PSNR min {exact_db:.2f} dB (bound {FRAME_MIN_DB}), "
          f"max |diff| {exact_err:.3e}; {r['samples']} samples, {hits} "
          f"hit rays of {H * W} (ray budget {r['ray_budget']})")
    for kind, t in (("eager exact", t_e), ("eager at the budgets", t_b),
                    ("graph", t_g)):
        print(_timing_line(tag, kind, t, "frame", 1))
    print(f"{tag}: {fg.captures} graphs captured in {fg.capture_seconds:.2f} "
          f"s (warm-ups included), {fg.replays} replays; head launches per "
          f"graph frame {launches} ({rows / max(launches, 1):.0f} rows each)")
    check(launches > 0, f"mode {mode}: the graph frame launched no head")
    check(t_g["peak_mib"] <= 1.2 * t_e["peak_mib"], f"mode {mode}: graph "
          f"peak {t_g['peak_mib']:.1f} MiB above 1.2x eager "
          f"{t_e['peak_mib']:.1f}")
    return r


def rays_overflow_check(avatar, state, grid, batch) -> dict:
    """Phase 19: a dense frame on graphs at priors too small for it
    (RAYS_TINY: 1% of the rays, 1024 cells) overflows both; it must
    re-render on graphs (rebaking) to the exact-count frame."""
    from instantavatar_torch.train import RenderSession
    av = mode_avatar(avatar, "dense")
    av.cell_budget = RAYS_TINY[1]
    passes = []
    dispatch = av._dispatch_frame
    av._dispatch_frame = lambda rec, rebake=False: (
        passes.append((rec["ray_budget"], rec["cell_budget"], rebake)),
        dispatch(rec, rebake))
    out = av._finish_frame(av._render_frame_async(
        state, batch, grid=grid, image_shape=(H, W),
        ray_budget_frac=RAYS_TINY[0]))
    del av._dispatch_frame
    exact = av.render_rays_frame(state, batch, grid, (H, W), RenderSession())
    db = psnr(out["rgb"], exact["rgb"])
    fg = av.frame_graphs
    print(f"[rays graph] dense, forced overflow at priors {RAYS_TINY}: "
          f"{len(passes)} renders (ray, cell budget, rebake: {passes}), "
          f"{fg.replays} graph replays, {fg.captures} captures; PSNR "
          f"{db:.2f} dB against the exact-count frame (bound "
          f"{FRAME_MIN_DB}), samples {out['n_samples']} vs "
          f"{int(exact['n_samples'])}")
    check(len(passes) >= 2 and any(p[2] for p in passes[1:])
          and fg.replays == len(passes) and db >= FRAME_MIN_DB
          and out["n_samples"] == int(exact["n_samples"]),
          "the forced ray-bundle overflow did not re-render on graphs to "
          "the exact frame")
    return {"renders": len(passes), "db": db}


def dp_render_graph_check(avatar, state, grid, batch) -> dict:
    """Phase 19: ``make_dp_render`` on the 540 px frame's rays over
    DP_RENDER_SHARDS in-process ray shards (``make_mesh`` with no process
    group), each shard's eval render (the full search per sample, the
    fused head) one graph replay: held against eager (``_held``), then
    timed warm in the default mode on a fresh capture."""
    from instantavatar_torch.parallel import make_dp_render, make_mesh
    av = mode_avatar(avatar, "flat")
    mesh = make_mesh(n_ray=DP_RENDER_SHARDS)
    check(mesh.group is None and mesh.n_ray == DP_RENDER_SHARDS,
          "make_dp_render's mesh is not in-process")
    rays = {k: v for k, v in batch.items() if k != "ray_basis"}

    def run(graph):
        out = make_dp_render(av, mesh, graph=graph)(state, rays, grid)
        torch.cuda.synchronize()
        return [out]
    algo, eager, graphed = _deterministic_pair(lambda: run(False),
                                               lambda: run(True))
    err = _held("make_dp_render", algo, eager, graphed)
    alpha = float(graphed[0]["alpha"].mean())
    check(bool(torch.isfinite(graphed[0]["rgb"]).all())
          and 0.05 < alpha < 0.95, f"make_dp_render: non-finite or "
          f"implausible frame (alpha coverage {alpha:.3f})")
    av.frame_graphs = None
    _, t_e = _timed_peak(lambda: run(False), DP_RENDER_TIMED)
    (_, launches, rows), t_g = _timed_peak(
        lambda: _counted(lambda: run(True)), DP_RENDER_TIMED)
    fg = av.frame_graphs
    tag = "[dp render graph]"
    print(f"{tag} {DP_RENDER_SHARDS} in-process shards of a {H} px frame's "
          f"rays ({H * W // DP_RENDER_SHARDS} each): graph vs eager "
          f"({algo} algorithms) max |diff| {err:.3e}; alpha coverage "
          f"{alpha:.3f}")
    for kind, t in (("eager", t_e), ("graph", t_g)):
        print(_timing_line(tag, kind, t, "frame", DP_RENDER_TIMED))
    print(f"{tag} {fg.captures} graphs captured in {fg.capture_seconds:.2f} "
          f"s, {fg.replays} replays; head launches per frame {launches} "
          f"({rows / max(launches, 1):.0f} rows each)")
    check(launches > 0, "make_dp_render's graphs launched no head")
    check(t_g["peak_mib"] <= 1.2 * t_e["peak_mib"], f"make_dp_render: "
          f"graph peak {t_g['peak_mib']:.1f} MiB above 1.2x eager "
          f"{t_e['peak_mib']:.1f}")
    return {"algorithms": algo, "max_err": err, "eager": t_e, "graph": t_g,
            "captures": fg.captures,
            "capture_s": fg.capture_seconds, "launches": launches,
            "rows": rows}


def rays_graph_phase(dev, avatar, state, grid) -> dict:
    """Phase 19: JAX's last jitted programs on graphs: each ray-bundle
    mode (``rays_mode_check``), a forced overflow
    (``rays_overflow_check``) and ``make_dp_render``
    (``dp_render_graph_check``). Returns each one's numbers and the head's
    launches and rows per path."""
    batch = modes_batch(dev)
    res = {m: rays_mode_check(avatar, state, grid, batch, m)
           for m in RAY_MODES}
    res["overflow"] = rays_overflow_check(avatar, state, grid, batch)
    res["dp_render"] = dp_render_graph_check(avatar, state, grid, batch)
    res["paths"] = {**{f"rays_graph_{m}": (res[m]["launches"],
                                           res[m]["rows"])
                       for m in RAY_MODES},
                    "dp_render_graph": (res["dp_render"]["launches"],
                                        res["dp_render"]["rows"])}
    return res


def main(profile_dir: Path | None) -> int:
    t_start = time.perf_counter()
    # -- 1. device --------------------------------------------------------
    # cuBLAS's deterministic workspace (phases 15 and 16 compare runs under
    # deterministic algorithms); read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from instantavatar_torch.data.rays import make_ray_basis
    from instantavatar_torch.kernels import (build_hash_library,
                                             build_knn_library,
                                             build_library, fused_field_head,
                                             fused_field_head_ref)
    from instantavatar_torch.train import RenderSession
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)   # the card's name and power limit, as nvidia-smi gives them
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build: one nvcc per kernel source, all started together ---------
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = [f.result() for f in [pool.submit(build_library),
                                       pool.submit(build_hash_library),
                                       pool.submit(build_knn_library)]]
    print(f"[build] the three kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for info in builds:
        print(f"[build] {info.path.name}: {info.seconds:.1f} s "
              f"(reused={info.reused})")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {line.strip()}")

    # -- 3. kernel vs plain, the yardsticks ----------------------------------
    head = kernel_phase(dev)

    # -- 4. the 540 px slice --------------------------------------------------
    avatar = make_avatar(dev, **SLICE_AVATAR_ARGS)
    t0 = time.perf_counter()
    state = avatar.init(np.zeros(10, np.float32))
    torch.cuda.synchronize()
    print(f"[slice] init, canonical bake (res 128) + optimizer set-up (the "
          f"first torch.optim use imports torch._dynamo): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    K = np.array([[2000.0, 0, W / 2], [0, 2000.0, H / 2], [0, 0, 1]])
    batch = {"ray_basis": make_ray_basis(K, np.eye(4)),
             "betas": np.zeros(10, np.float32),
             "body_pose": np.zeros(69, np.float32),
             "global_orient": np.zeros(3, np.float32),
             "transl": np.array([0.0, 0.15, 5.0], np.float32)}
    grid = avatar.build_pose_grid(state, batch)
    print(f"[slice] shell grid: {int(grid.occupancy.sum())} occupied of "
          f"{avatar.grid_size ** 3} cells")
    session = RenderSession()
    for _ in range(2):
        avatar.render_frame(state, batch, grid=grid, image_shape=(H, W),
                            session=session)
    frames = [{**batch, "global_orient": np.array(
        [0.0, 2 * np.pi * i / 8, 0.0], np.float32)} for i in range(8)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_field_head.launches = 0
    fused_field_head.rows = 0
    t0 = time.perf_counter()
    outs = list(avatar.render_frames(state, frames, grid=grid,
                                     image_shape=(H, W), session=session))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / len(frames)
    launches, rows = fused_field_head.launches, fused_field_head.rows
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, "the turntable never launched the CUDA head")
    for o in outs:
        check(bool(torch.isfinite(o["rgb"]).all())
              and bool(torch.isfinite(o["alpha"]).all()),
              "non-finite rgb/alpha")
    cover = [float(o["alpha"].mean()) for o in outs]
    check(all(0.05 < c < 0.95 for c in cover),
          f"implausible alpha coverage {cover}")
    print(f"[slice] 540x540 turntable, 8 frames: {dt * 1e3:.2f} ms/frame, "
          f"{H * W / dt:.0f} rays/s, peak memory {peak / 2**20:.1f} MiB")
    print(f"[slice] kept samples/frame {[o['n_samples'] for o in outs]}, "
          f"occupied cells {outs[0]['n_occ']}, kernel launches {launches}, "
          f"rows through the kernel/frame {rows / len(frames):.0f}, "
          f"alpha coverage {min(cover):.3f}-{max(cover):.3f}")

    # a frame that pays its own warp-cache bake: two poses alternate in
    # one session (the budgets learned and the graphs captured first)
    own = RenderSession()
    posed = {**frames[1], "body_pose": frames[1]["body_pose"] + 0.05}
    for f in (frames[1], posed, frames[1]):
        avatar.render_frame(state, f, grid=grid, image_shape=(H, W),
                            session=own)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avatar.render_frame(state, posed, grid=grid, image_shape=(H, W),
                        session=own)
    torch.cuda.synchronize()
    print(f"[slice] frame with its own bake: "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

    # compositing precision: the same stream composited in float64
    stream = avatar.render_stream(state, frames[1], grid, (H, W), session)
    c32 = avatar.composite_frame(stream)["rgb"]
    c64 = avatar.composite_frame(stream, dtype=torch.float64)["rgb"]
    comp_err = float((c32.double() - c64).abs().max())
    comp_db = psnr(c32, c64)
    print(f"[slice] fp32 vs float64 composite of one frame's stream "
          f"({stream.z.shape[0]} samples): max|rgb diff| {comp_err:.3e}, "
          f"PSNR {comp_db:.1f} dB")
    check(comp_db >= 50.0, "fp32 stream compositing drifted")

    if profile_dir is not None:
        def two_frames():
            for f in frames[:2]:
                avatar.render_frame(state, f, grid=grid, image_shape=(H, W),
                                    session=session)
        profile(two_frames, profile_dir, "torch_profile", "2 frames")

    # -- 5. head swap -----------------------------------------------------------
    # both renders bake afresh, so they differ only in the head
    kern = avatar.render_frame(state, frames[1], grid=grid,
                               image_shape=(H, W))
    avatar.field.head_fn = fused_field_head_ref
    ref = avatar.render_frame(state, frames[1], grid=grid, image_shape=(H, W))
    avatar.field.head_fn = None
    swap_db = psnr(kern["rgb"], ref["rgb"])
    print(f"[head swap] kernel vs plain head, frame 1: PSNR {swap_db:.1f} dB "
          f"(bound {HEAD_SWAP_MIN_DB})")
    check(swap_db >= HEAD_SWAP_MIN_DB, "head swap changed the frame")

    # -- 6. golden ------------------------------------------------------------
    from instantavatar_torch import convert
    g = np.load(ROOT / "tests" / "data" / "torch_slice_golden.npz")
    Hg, G = int(g["image_hw"]), int(g["grid_size"])
    small = make_avatar(dev, deformer_res=int(g["deformer_res"]),
                        grid_size=G, voxel_res=int(g["voxel_res"]),
                        plane_res=int(g["plane_res"]),
                        param_seed=int(g["param_seed"]),
                        sigma_bias=float(g["sigma_bias"]),
                        shell_margin=float(g["shell_margin"]))
    gstate = small.init(g["betas"])
    occ = np.unpackbits(g["occupancy_bits"])[:G ** 3].astype(bool)
    ggrid = convert.grid_state_from_numpy(
        {"density_cached": np.zeros((G, G, G), np.float32),
         "occupancy": occ.reshape(G, G, G), "aabb": g["aabb"]}, device=dev)
    gbatch = {k: g[k] for k in ("ray_basis", "betas", "body_pose",
                                "global_orient", "transl")}
    gout = small.render_frame(gstate, gbatch, grid=ggrid,
                              image_shape=(Hg, Hg))
    gold_db = psnr(gout["rgb"], torch.as_tensor(g["rgb"], device=dev))
    alpha_err = float((gout["alpha"].cpu() - torch.as_tensor(g["alpha"]))
                      .abs().max())
    print(f"[golden] {Hg}px port on {torch.cuda.get_device_name(0)} vs JAX "
          f"on CPU: rgb PSNR {gold_db:.1f} dB (bound {GOLDEN_MIN_DB}), "
          f"max|alpha diff| {alpha_err:.3e}")
    check(gold_db >= GOLDEN_MIN_DB, "golden frame disagrees")

    # -- 7, 8. training and validation --------------------------------------
    train = train_phase(dev, profile_dir=profile_dir)

    # -- 9. training golden ---------------------------------------------------
    replay_train_golden(dev)

    # -- 11. the entry points ---------------------------------------------------
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work:
        cli = cli_phase(dev, Path(work))
        # -- 12. the confs' default network -------------------------------
        ngp = ngp_phase(dev, Path(work))
        # -- 13. the in-the-wild demo -------------------------------------
        demo = demo_phase(dev, Path(work))
        refine_full_phase(dev)
        # -- 14. the data engine, MocapDataset, the triplane field --------
        data_phase(dev, Path(work))
        triplane_phase(dev, Path(work))
        # -- 15. the parallel layer -----------------------------------------
        par = {**dp_train_check(dev, Path(work)),
               **dp_render_check(dev, avatar, state, grid, batch,
                                 Path(work))["paths"],
               **multi_phase(dev, Path(work), cli)["paths"]}
        # -- 16. the captured step against the eager one ---------------
        graphs = graph_phase(dev, Path(work))
        par.update(graphs["paths"])
        # -- 18.1, 18.2: the DP and multi-subject steps on graphs -------
        par.update(dp_graph_check(dev, Path(work))["paths"])
        par.update(multi_graph_check(dev)["paths"])
    # -- 14. the eval modes on phase 4's avatar --------------------------------
    modes = modes_phase(dev, avatar, state, grid)
    # -- 17 (and 18.3). the flat frame and the per-pose grids on graphs -------
    par.update(frame_phase(dev, avatar, state, grid, frames)["paths"])
    # -- 19. the ray-bundle frames and make_dp_render on graphs ---------------
    par.update(rays_graph_phase(dev, avatar, state, grid)["paths"])

    # -- 10. the kernel at each path's rows per launch ------------------------
    paths = {**cli["paths"], **demo["paths"], **par,
             **{f"mode_{m}": (r["launches"], r["rows"])
                for m, r in modes.items()}}
    by_path = {"turntable": launches, "train": train["train_launches"],
               "val_render": train["val_launches"],
               **{k: v[0] for k, v in paths.items()}}
    rows_by_path = {"turntable": rows, "train": train["train_rows"],
                    "val_render": train["val_rows"],
                    **{k: v[1] for k, v in paths.items()}}
    rows_per_launch = {k: rows_by_path[k] / n for k, n in by_path.items()
                       if n}
    ms_by_path, path_err = path_timings(dev, rows_per_launch)
    print(f"[smoke] all phases ran in {time.perf_counter() - t_start:.1f} s "
          f"(the kernel's build included)")

    enc_by_path = {**ngp["encode_paths"], **demo["encode_paths"],
                   **graphs["encode_paths"]}
    t = ngp["encode"]["train_step_call"]
    a = ngp["encode"]["animate_frame_call"]
    print(f"[smoke] hash-encode kernel launches by path "
          f"{ {k: v[0] for k, v in enc_by_path.items()} }")
    nv = demo["ops"]["toy7008_grid_cells"]
    nw = demo["ops"]["warp"]
    print(f"[smoke] nearest-vertex kernel launches by path "
          f"{ {k: v[0] for k, v in KNN_PATHS.items()} }")
    check(all(KNN_PATHS[k][0] > 0 for k in (
        "cli_animate", "demo_fit", "demo_train", "smpl_voxel_frame",
        "frame_graph_animate")), "a path that searches the nearest vertex "
          "on the card never launched the kernel")
    print(f"[smoke] nearest-warp kernel launches (SMPLDeformer.deform calls "
          f"on the card) by path "
          f"{ {k: f'{v[0]} ({v[2]})' for k, v in WARP_PATHS.items()} }")
    check(all(v[0] > 0 for v in WARP_PATHS.values() if v[2]),
          "a path that calls SMPLDeformer.deform on the card never launched "
          "the warp kernels")
    print(json.dumps({"kernels": [{
        "name": "fused_field_head", "route": "cuda",
        "source": "instantavatar_torch/csrc/fused_head.cu",
        "replaces": "instantavatar_tpu/ops/fused_head.py:53",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "rows_per_launch_by_path": rows_per_launch,
        "ms_by_path": ms_by_path,
        "max_abs_err": max(head["max_err"], path_err),
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"]}, {
        "name": "hash_encode", "route": "cuda",
        "source": "instantavatar_torch/csrc/hash_encode.cu",
        "replaces": "instantavatar_tpu/ops/hashgrid.py:82",
        "launches": sum(v[0] for v in enc_by_path.values()),
        "launches_by_path": {k: v[0] for k, v in enc_by_path.items()},
        "rows_per_launch_by_path": {k: v[1] / v[0]
                                    for k, v in enc_by_path.items()},
        "max_abs_err": ngp["encode"]["max_err"],
        "points": t["rows"],
        "ms": t["fwd_bwd_kernel_ms"], "plain_ms": t["fwd_bwd_plain_ms"],
        "bound_ms": t["fwd_bwd_bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "fwd_ms": t["fwd_kernel_ms"], "fwd_plain_ms": t["fwd_plain_ms"],
        "fwd_bound_ms": t["fwd_bound_ms"],
        "deterministic_ms": t["fwd_bwd_kernel_det_ms"],
        "fwd_bwd_x_ms": t["fwd_bwd_x_kernel_ms"],
        "fwd_bwd_x_bound_ms": t["fwd_bwd_x_bound_ms"],
        "bwd_x_ms": t["bwd_x_kernel_ms"], "bwd_x_bound_ms": t["bwd_x_bound_ms"],
        "animate_points": a["rows"], "animate_fwd_ms": a["fwd_kernel_ms"],
        "animate_fwd_bound_ms": a["fwd_bound_ms"],
        "features_checked": sorted({2, *(c.n_features
                                         for c in encode_grids())})}, {
        "name": "nearest_vertex", "route": "cuda",
        "source": "instantavatar_torch/csrc/nearest_vertex.cu",
        "replaces": "instantavatar_tpu/deformers/smpl_deformer.py:67",
        "launches": sum(v[0] for v in KNN_PATHS.values()),
        "launches_by_path": {k: v[0] for k, v in KNN_PATHS.items()},
        "rows_per_launch_by_path": {k: v[1] / v[0]
                                    for k, v in KNN_PATHS.items() if v[0]},
        "max_abs_err": 0.0,     # bit-equal to the plain version (op_timings)
        "points": nv["points"], "verts": nv["verts"],
        "ms": nv["kernel"]["ms"], "plain_ms": nv["plain"]["ms"],
        "bound_ms": nv["bound_ms"], "bound_by": nv["bound_by"],
        "library_ms": None}, {
        "name": "nearest_warp", "route": "cuda",
        "source": "instantavatar_torch/csrc/nearest_vertex.cu",
        "replaces": "instantavatar_tpu/deformers/smpl_deformer.py (deform)",
        "launches": sum(v[0] for v in WARP_PATHS.values()),
        "launches_by_path": {k: v[0] for k, v in WARP_PATHS.items()},
        "rows_per_launch_by_path": {k: v[1] / v[0]
                                    for k, v in WARP_PATHS.items() if v[0]},
        "deform_calls_by_path": {k: v[2] for k, v in WARP_PATHS.items()},
        "max_abs_err": nw["fwd_max_abs_err"],
        "grad_rel_err": max(nw["grad_T_rel"], nw["grad_pts_rel"]),
        "points": nw["points"], "verts": nw["verts"],
        "merged_share": nw["merged_share"],
        "ms": nw["fwd_bwd_kernel"]["ms"],
        "plain_ms": nw["fwd_bwd_plain"]["ms"],
        "bound_ms": nw["fwd_bwd_bound_ms"], "bound_by": "bytes",
        "index_select_ms": nw["fwd_bwd_index_select"]["ms"],
        "fwd_ms": nw["fwd_kernel"]["ms"], "fwd_plain_ms": nw["fwd_plain"]["ms"],
        "fwd_index_select_ms": nw["fwd_index_select"]["ms"],
        "fwd_bound_ms": nw["fwd_bound_ms"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, metavar="DIR",
                    help="write a torch.profiler summary and trace here")
    sys.exit(main(ap.parse_args().profile))
