"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives ``instantavatar_torch``'s flagship novel-view render (toy body,
Fast-SNARF res 128, voxel+triplane field at full width, flat-stream
render at 540x540, the bench.py configuration with random numpy-seeded
weights) and its training (the same configuration as
``tools/quality_bench.py:make_flagship(reduced=True)``) through the entry
points a user calls, and checks it in phases:

  1. device: a CUDA card is required (no CPU run); TF32 is switched off;
  2. build: the fused field-head kernel is compiled from csrc/ with nvcc;
  3. kernel vs its plain PyTorch version at M = 1, 17, 1000, one pass of
     the persistent grid +- 1 and 1,000,003 rows; the kernel, the plain
     version and the library yardstick (five bf16 cuBLAS GEMMs, see
     ``cublas_chain``) timed in turns with CUDA events at 1.5M rows,
     beside the kernel's bound (``head_cost`` at 3.35 TB/s and 989
     TFLOP/s);
  4. the 540 px slice: 2 warm frames, then an 8-frame turntable through
     ``render_frames``; the kernel's launch counter must rise;
  5. head swap: one frame again with the plain head, PSNR-bounded;
  6. golden: the committed JAX golden frame (96 px), PSNR-bounded;
  7. training: a 264 px capsule scene (30 train + 2 val frames, made on
     the card), 150 ``AvatarModel.step`` calls (5 epochs; grid update and
     occupancy regularizer every 20 steps, cached-search steps between,
     Adam with the 20-epoch decay); step times, peak memory, occupied
     cells, the loss fall (bounded);
  8. validation: the 2 val frames rendered with ``eval_grid="density"``
     (``build_test_grid``, then the flat render through the kernel),
     PSNR-bounded against the GT;
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
     (``network=voxel_triplane``, the rest at conf defaults) for 5 epochs,
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
     the depth term logged), ``animate`` at 540 px; then ``hash_encode``
     (plain PyTorch, not a TPU kernel) timed forward and forward plus
     backward on the largest call of a training step and of an animate
     frame, with its device launches per call and its byte bound, and the
     committed JAX NGP golden frame (48 px), PSNR-bounded;
 13. the in-the-wild demo (``bash/run-neuman-demo.sh``) on a copy of phase
     11's sequence read as ``dataset=custom/video``: ``fit`` with
     ``SNARF_NGP_fitting deformer=smpl`` at the conf's defaults (LPIPS with
     the random VGG trunk, the depth term, SMPL lr 1e-4; every frame
     exported, both patch terms finite, the SMPL parameters moved),
     ``train --config-name demo sampler.dilate=8`` on the fitted poses
     (per-frame smpl_init grids (F, 64, 64, 64), each partly occupied,
     the seeded stack held by the 500-step latch, val PSNR above an
     all-white frame's; ms/step, peak memory), ``novel_view`` and
     ``animate`` at 540 px and ``animate`` at 67 px (the 1-pixel-block
     render); ``nearest_vertex`` (against the 192-vertex toy body and a
     7,008-vertex one) and the LPIPS VGG trunk timed beside their bounds
     with their device launches per call (plain PyTorch, XLA in the JAX
     package: not TPU kernels); the committed JAX SMPL-deformer golden
     frame (48 px), PSNR-bounded; one 540 px SMPL-deformer frame with the
     voxel-triplane field, which must launch the fused head;
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
     the alpha skip): warm ms/frame, head launches and rows (each must
     launch the head), rgb PSNR against the flat and the dense frame and,
     as in phase 5, against the mode's frame with the plain head
     (PSNR-bounded);
 15. the parallel layer (``instantavatar_torch.parallel``) on the one
     card: 20 DP training steps of phase 7's configuration (the first a
     grid update) on 2 ranks over gloo sharing the card (parameters
     bit-identical on both afterwards; step 1's losses within 1e-4 of the
     single-process step on the whole batch fed the ranks' draws, its
     grid exactly) and on one NCCL rank (step 1 equal to the
     single-process step to the bit, both with PyTorch's deterministic
     algorithms); ms/step and the bytes reduced; phase 4's 540 px
     turntable of 3 on 2 gloo ranks in the stride and band layouts
     (each rank launching the head, the bake memo engaged, PSNR-bounded
     against the single-device frames) and the gather of a frame's bands
     timed; one band's program alone for R = 2, 4, 8 (stride) and 4
     (band) beside the replicated bake; ``train_multi`` with two copies
     of phase 11's sequence for 2 epochs, each subject's checkpoint
     through ``animate``. Spawned ranks report their head launches and
     rows through files.

Any failed check, a spawned rank's non-zero exit or a spawned run past
its time limit exits non-zero. The last stdout line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``
and the line before it lists the kernels, with the kernel's launches in
each path (turntable, training, val render, phase 11's CLI train run,
Trainer validation, Trainer test, animate and novel_view, and phase 13's
SMPL-deformer voxel-triplane frame, phase 14's eval modes, and phase
15's ranks and paths; the NGP and triplane paths evaluate the fp32 head
and launch no kernel). ``--profile DIR`` also
writes torch.profiler summaries and traces of two steady-state frames and
of one grid-update step plus three plain training steps to DIR.

Run from the repository root:  python3 chip_smoke.py [--profile DIR]
"""
from __future__ import annotations

import json
import math
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
# phase 12: the NGP golden's floor, fit's epochs, the default table's bytes
NGP_GOLDEN_MIN_DB, FIT_EPOCHS = 35.0, 2
NGP_TABLE_BYTES = 16 * 2 ** 19 * 2 * 4
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


def _counted(fn):
    """Run ``fn`` with the head's counters at 0; returns (result,
    launches, rows) of that run."""
    from instantavatar_torch.kernels import fused_field_head
    fused_field_head.launches = 0
    fused_field_head.rows = 0
    out = fn()
    torch.cuda.synchronize()
    return out, fused_field_head.launches, fused_field_head.rows


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

    g = np.random.default_rng(0)
    poses = np.zeros((CLI_POSES, 72), np.float32)
    poses[:, 1] = np.linspace(-0.6, 0.6, CLI_POSES)     # yaw
    poses[:, 3 + 47] = 0.6 * np.sin(np.arange(CLI_POSES))
    poses[:, 3 + 50] = -0.6 * np.sin(np.arange(CLI_POSES))
    poses[:, 3:] += 0.05 * g.standard_normal((CLI_POSES, 69))
    trans = np.tile(np.array([[0.0, 0.0, 3.0]], np.float32), (CLI_POSES, 1))
    np.savez(work / "poses.npz", poses=poses, trans=trans)
    rd = "+render_downscale=2"
    anim, *paths["cli_animate"] = _counted(lambda: animate.main(
        ["--config-name", "SNARF_NGP", f"+pose_sequence={work / 'poses.npz'}",
         rd, *over]))
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
    ``module.attr`` (the name its callers read; with ``steps_only``,
    inside ``AvatarModel.step`` only, so a training run's validation
    renders are left out) until the returned ``stop`` is called, and keep
    the points of the largest call; wrappers, no device sync."""
    from instantavatar_torch.train import AvatarModel
    real, real_step = getattr(module, attr), AvatarModel.step
    calls: list = []
    largest: dict = {"x": None}
    inside = [not steps_only]

    def counted(*a, **kw):
        if inside[0]:
            entry, x = describe(*a)
            calls.append(entry)
            if largest["x"] is None or x.shape[0] > largest["x"].shape[0]:
                largest["x"] = x.detach().clone()
        return real(*a, **kw)

    def step(self, *a, **kw):
        inside[0] = True
        out = real_step(self, *a, **kw)
        inside[0] = not steps_only
        return out

    def stop():
        setattr(module, attr, real)
        AvatarModel.step = real_step
    setattr(module, attr, counted)
    AvatarModel.step = step
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


def encode_bound(rows: int, touched: int, backward: bool) -> float:
    """Least time (ms) of ``hash_encode`` on ``rows`` points that touch
    ``touched`` distinct table rows, at the HBM rate (the FLOPs, ~1 KFLOP
    per point, take <1% of that at the fp32 rate): 12 B of points in and
    128 B of fp32 features out per point plus 8 B per touched table row;
    with the backward also the 128 B per point of incoming gradient, the
    12 B per point of point gradient and the dense 64 MiB table gradient
    written once."""
    nbytes = rows * (12 + 128) + touched * 8
    if backward:
        nbytes += rows * (128 + 12) + NGP_TABLE_BYTES
    return 1e3 * nbytes / HBM_BYTES_PER_S


def encode_timing(dev, path_points: dict[str, torch.Tensor]) -> dict:
    """The hash encode on each path's largest call (its normalized
    points, as the field encoded them; random table): forward, and
    forward plus backward, median of 15 (CUDA events), its device
    launches per call (torch.profiler) and its bound."""
    from instantavatar_torch.ops import HashGridConfig, hash_encode, hash_slots
    cfg = HashGridConfig()
    g = np.random.default_rng(3)
    table = torch.as_tensor(g.normal(0.0, 0.1, (cfg.n_levels, cfg.table_size,
                                                cfg.n_features))
                            .astype(np.float32), device=dev)
    out = {}
    for path, x in path_points.items():
        rows = x.shape[0]
        touched = int(torch.unique(
            (hash_slots(x, cfg) + torch.arange(cfg.n_levels, device=dev)
             [:, None] * cfg.table_size).reshape(-1)).numel())
        tab = table.clone().requires_grad_()
        ct = torch.ones((rows, cfg.out_dim), device=dev)

        def fwd():
            with torch.no_grad():
                hash_encode(table, x, cfg)

        def fwd_bwd():
            tab.grad = None
            hash_encode(tab, x, cfg).backward(ct)
        res = {"rows": rows, "touched_rows": touched}
        for name, fn, bwd in (("fwd", fwd, False), ("fwd_bwd", fwd_bwd, True)):
            for _ in range(3):
                fn()
            launches = device_launches(fn)
            ms = statistics.median(cuda_ms(fn, 15))
            bound = encode_bound(rows, touched, bwd)
            res.update({f"{name}_ms": ms, f"{name}_launches": launches,
                        f"{name}_bound_ms": bound})
            print(f"[encode] {path}: {rows} points ({touched} distinct table "
                  f"rows), {name}: {ms:.4f} ms (median of 15, CUDA events), "
                  f"{launches} device launches per call (torch.profiler), "
                  f"bound {bound:.4f} ms set by bytes, "
                  f"{100 * bound / ms:.1f}% of it")
        out[path] = res
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
    res = {}

    # -- train ----------------------------------------------------------------
    calls, train_x, stop = _count_encode(steps_only=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, state = train.main(["--config-name", "SNARF_NGP",
                                 f"train.max_epochs={CLI_EPOCHS}",
                                 f"train.check_val_every_n_epoch={CLI_EPOCHS}",
                                 *over])
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
    t0 = time.perf_counter()
    rtrainer, rstate, test_m = eval_cli.main(["--config-name",
                                              "SNARF_NGP_refine", *over])
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
    seq_fit = work / "seq_fit"
    shutil.copytree(seq, seq_fit)
    t0 = time.perf_counter()
    ftrainer, fstate, poses = fit.main(
        ["--config-name", "SNARF_NGP_fitting",
         f"train.max_epochs={FIT_EPOCHS}",
         *cli_overrides(seq_fit, work / "fit_run")])
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
    calls, anim_x, stop = _count_encode()
    anim = animate.main(["--config-name", "SNARF_NGP",
                         f"+pose_sequence={work / 'poses.npz'}",
                         "+render_downscale=2", *over])
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
    per_row_fwd = t["fwd_ms"] / t["rows"]
    per_row_fb = t["fwd_bwd_ms"] / t["rows"]
    te = res["train_encode"]
    step_enc = (per_row_fb * te["grad_rows"]
                + per_row_fwd * (te["rows"] - te["grad_rows"])) / steps
    a = enc["animate_frame_call"]
    frame_enc = a["fwd_ms"] / a["rows"] * res["animate_encode_rows"]
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
    return res


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
    """Phase 13's op timings: ``nearest_vertex`` (plain PyTorch; XLA in
    the JAX package) at the largest deform call of a fit step and at the
    ``grid_size``^3 cells of a grid update, against the CLIs' 192-vertex toy body
    and a 7,008-vertex toy body (SMPL's width: 6,890), and the LPIPS VGG
    trunk forward and forward plus backward on the fit step's patch
    stack; median of 15 (CUDA events), device launches per call, bound."""
    from instantavatar_torch.body import toy_smpl_model
    from instantavatar_torch.deformers import SMPLDeformer
    from instantavatar_torch.losses import load_lpips
    from instantavatar_torch.ops import nearest_vertex
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

            def fn():
                nearest_vertex(x, verts)
            for _ in range(3):
                fn()
            ms = statistics.median(cuda_ms(fn, 15))
            bound, by = knn_bound(M, V)
            key = f"{body_name}_{call}"
            out[key] = {"points": M, "verts": V, "ms": ms,
                        "launches": device_launches(fn), "bound_ms": bound,
                        "bound_by": by}
            print(f"[knn] nearest_vertex {key}: {M} points x {V} vertices: "
                  f"{ms:.4f} ms (median of 15, CUDA events), "
                  f"{out[key]['launches']} device launches per call "
                  f"(torch.profiler), bound {bound:.4f} ms set by {by}, "
                  f"{100 * bound / ms:.1f}% of it")
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
    res = {}

    # -- fit ------------------------------------------------------------------
    import instantavatar_torch.deformers.smpl_deformer as sd_mod
    calls, fit_x, stop = _record_calls(
        sd_mod, "nearest_vertex",
        lambda pts, verts, *_: ((pts.shape[0], verts.shape[0]), pts),
        steps_only=True)
    t0 = time.perf_counter()
    ftr, fstate, poses = fit.main(
        ["--config-name", "SNARF_NGP_fitting", *data, "deformer=smpl",
         f"train.max_epochs={FIT_EPOCHS}",
         *cli_overrides(seq, work / "demo_fit")])
    torch.cuda.synchronize()
    stop()
    res["fit_cli_s"] = time.perf_counter() - t0
    fsteps = FIT_EPOCHS * CLI_TRAIN
    res["fit_ms_per_step"] = 1e3 * sum(ftr.epoch_seconds) / fsteps
    res["fit_knn_calls"] = len(calls) / fsteps
    exported = np.load(poses)
    losses = {k: float(v) for k, v in ftr.last_losses.items()}
    sp0 = ftr.dm.trainset.get_smpl_params()
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

    # -- train with the demo conf -------------------------------------------
    run = work / "demo_run"
    over = [*data, *cli_overrides(seq, run)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, state = train.main(
        ["--config-name", "demo", "sampler.dilate=8",
         f"train.max_epochs={CLI_EPOCHS}",
         f"train.check_val_every_n_epoch={CLI_EPOCHS}", *over])
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
        out = cli.main([*demo, f"+render_downscale={ds}", *extra, *over])
        side = animate.make_camera(ds)[0]
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

    # -- the SMPL-deformer golden ---------------------------------------------
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


def modes_phase(dev, avatar, state, grid) -> dict:
    """Phase 14, the eval modes: one 540 px frame of phase 4's avatar,
    state and shell grid in each of EVAL_MODES (a model per mode on the
    same body, field and deformer; the frame carries per-pixel rays for
    the ray-bundle modes). Per mode: warm ms/frame (the second frame of a
    session: the bake reused, as on the turntable), the head's launches
    and rows, rgb PSNR against the flat and the dense frame, and, as in
    phase 5, against the same mode rendered (and baked) with the plain
    head in the kernel's place."""
    from instantavatar_torch.data.rays import make_ray_basis, make_ray_grid
    from instantavatar_torch.kernels import fused_field_head_ref
    from instantavatar_torch.train import AvatarModel, RenderSession
    K = np.array([[2000.0, 0, W / 2], [0, 2000.0, H / 2], [0, 0, 1]])
    ro, rd = make_ray_grid(K, np.eye(4), H, W)
    batch = {"ray_basis": make_ray_basis(K, np.eye(4)),
             "rays_o": torch.as_tensor(ro.reshape(-1, 3), device=dev),
             "rays_d": torch.as_tensor(rd.reshape(-1, 3), device=dev),
             "betas": np.zeros(10, np.float32),
             "body_pose": np.zeros(69, np.float32),
             "global_orient": np.array([0.0, 0.5, 0.0], np.float32),
             "transl": np.array([0.0, 0.15, 5.0], np.float32)}
    res, rgbs = {}, {}
    base = {**AVATAR_540_KW, "grid_size": avatar.grid_size,
            "shell_margin": avatar.shell_margin}
    for mode, knobs in EVAL_MODES.items():
        av = AvatarModel(avatar.body, avatar.field, avatar.deformer,
                         **base, **knobs)
        sess = RenderSession()
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


def _dp_train_rank(rank: int, world: int, work: str, tag: str,
                   deterministic: bool) -> None:
    """Phase 15 rank: ``dp_train_in.pt``'s steps of phase 7's flagship
    configuration over the ray group (the first a grid update), from the
    parent's checkpoint, this rank's draws from ``rank_draws``, with
    PyTorch's deterministic algorithms when ``deterministic``. Writes the
    first step's losses, grid and parameters, the last parameters, the
    step times, the bytes reduced per step, and the head's launches and
    rows of the run, and the plain step's bucket all-reduced alone. The
    deterministic algorithms (slow: a sorted ``index_add_``) hold for the
    first step only."""
    import torch.distributed as dist
    from instantavatar_torch.kernels import fused_field_head
    from instantavatar_torch.parallel import (make_dp_train_step, make_mesh,
                                              rank_draws)
    from instantavatar_torch.train.harness import restore_checkpoint
    work = Path(work)
    inp = torch.load(work / "dp_train_in.pt", weights_only=False)
    dev = _rank_device(inp["device"])
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
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
            out["params0"] = _flat_params(avatar)
            torch.use_deterministic_algorithms(False)
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
    torch.save(out, work / f"dp_train_{tag}_{rank}.pt")


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


def dp_train_check(dev, work: Path, *, size=TRAIN_SIZE,
                   n_train=TRAIN_FRAMES, **config) -> dict:
    """Phase 15.1: DP_STEPS training steps of phase 7's configuration
    (``config``: ``make_trainer``'s sizes) on DP_RANKS gloo ranks sharing
    the card, then on one NCCL rank, each rank's first step held against
    the single-process step. Returns each run's head launches and rows."""
    from instantavatar_torch.parallel import make_mesh, rank_draws, run_ranks
    from instantavatar_torch.train import StepDraws
    from instantavatar_torch.train.harness import (restore_checkpoint,
                                                   save_checkpoint)
    _, train, _ = capsule_splits(dev, size, n_train, 1)
    trainer_kw = {"steps_per_epoch": n_train, **config}
    avatar = make_trainer(dev, **trainer_kw)
    betas = train.smpl_params["betas"]
    state = avatar.init(betas, generator=torch.Generator(
        device=dev).manual_seed(0))
    ckpt = save_checkpoint(work / "dp_ckpt", state, avatar.field)
    batches = [train[i % n_train] for i in range(DP_STEPS)]
    torch.save({"device": str(dev), "trainer_kw": trainer_kw, "ckpt": ckpt,
                "betas": betas, "batches": batches}, work / "dp_train_in.pt")
    n_rays = int(np.prod(batches[0]["rays_o"].shape[:-1]))
    paths = {}
    for tag, backend, world in (("gloo", "gloo", DP_RANKS),
                                ("nccl", "nccl" if dev.type == "cuda"
                                 else "gloo", 1)):
        # the one-rank run and its reference take PyTorch's deterministic
        # algorithms (index_add_'s CUDA atomics sum in any order), so that
        # two runs of one step can agree to the bit
        exact = world == 1
        secs = run_ranks(_dp_train_rank, world, backend=backend,
                         store_dir=work, args=(str(work), tag, exact),
                         timeout=SPAWN_TIMEOUT,
                         threads=torch.get_num_threads())
        ranks = _load_ranks(work, f"dp_train_{tag}", world)
        ref = make_trainer(dev, **trainer_kw)
        rstate = restore_checkpoint(ckpt, ref.init(betas), ref.field)
        mesh = make_mesh(n_ray=world)
        parts = [rank_draws(ref, mesh, DP_SEED, n_rays // world, True, ray=r)
                 for r in range(world)]
        draws = StepDraws(torch.cat([d.jitter for d in parts]),
                          torch.cat([d.noise for d in parts]),
                          parts[0].grid_jitter)
        torch.use_deterministic_algorithms(exact, warn_only=True)
        try:
            rstate, rl = ref.train_step_update(rstate, batches[0], draws)
        finally:
            torch.use_deterministic_algorithms(False)
        rl = {k: float(v) for k, v in rl.items()}
        r0 = ranks[0]
        gap = max(abs(r0["losses0"][k] / rl[k] - 1.0) for k in
                  ("mse_loss", "loss_alpha", "reg_alpha", "reg_occupancy",
                   "loss"))
        occ_ok = torch.equal(r0["occupancy0"], rstate.grid.occupancy.cpu())
        dens = float((r0["density0"]
                      - rstate.grid.density_cached.cpu()).abs().max())
        # step 0 is cold (and deterministic in the one-rank run)
        plain = [m for m, u in zip(r0["ms"][1:], r0["update"][1:]) if not u]
        upd = [m for m, u in zip(r0["ms"][1:], r0["update"][1:]) if u]
        print(f"[dp train] {tag}: {world} rank(s) on "
              f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else dev}"
              f", {DP_STEPS} steps of phase 7's configuration "
              f"({n_rays // world} rays per rank): median "
              f"{statistics.median(plain):.2f} ms per plain step, "
              f"{statistics.median(upd or [math.nan]):.2f} ms per warm "
              f"grid-update step, the cold first {r0['ms'][0]:.0f} ms; "
              f"{r0['bytes'][1] / 2 ** 20:.2f} MiB reduced per plain step "
              f"({r0['bytes'][0] / 2 ** 20:.2f} with the grid), its "
              f"all_reduce alone {r0['all_reduce_ms']:.2f} ms (median of "
              f"5); the ranks ran {secs:.1f} s with start-up")
        print(f"[dp train] {tag}: step 1 against the single-process step "
              f"on the whole batch with the ranks' draws: worst loss gap "
              f"{gap:.2e} (tol {DP_LOSS_RTOL if world > 1 else 0}), grid "
              f"occupancy equal {occ_ok}, density max|diff| {dens:.3e}")
        check(occ_ok and dens == 0.0, f"{tag}: the DP grid update differs")
        if world > 1:
            check(gap <= DP_LOSS_RTOL, f"{tag}: DP losses disagree")
            same = all(torch.equal(r["params"], r0["params"])
                       for r in ranks[1:])
            print(f"[dp train] {tag}: parameters bit-identical on the "
                  f"{world} ranks after {DP_STEPS} steps: {same}; two ranks "
                  f"share one card here, so the step time is no scaling "
                  f"number")
            check(same, "the DP ranks' parameters drifted apart")
        else:
            same = (r0["losses0"] == rl
                    and torch.equal(r0["params0"], _flat_params(ref)))
            print(f"[dp train] {tag}: one rank's step (its all_reduce the "
                  f"identity) equals the single-process step exactly "
                  f"(losses, grid, parameters; deterministic algorithms in "
                  f"both): {same}")
            check(same, "the one-rank DP step differs from the "
                  "single-process step")
        launches = sum(r["launches"] for r in ranks)
        check(dev.type != "cuda" or launches > 0,
              f"dp_train_{tag} never launched the CUDA head")
        paths[f"dp_train_{tag}"] = (launches, sum(r["rows"] for r in ranks))
    return paths


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
            avatar._bake(state, dstate, grid)
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
          f"{MULTI_EPOCHS} epochs: {ms:.2f} ms per combined step "
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



def main(profile_dir: Path | None) -> int:
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from instantavatar_torch.data.rays import make_ray_basis
    from instantavatar_torch.kernels import (build_library, fused_field_head,
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

    # -- 2. build -----------------------------------------------------------
    info = build_library()
    print(f"[build] {info.path.name}: {info.seconds:.1f} s "
          f"(reused={info.reused})")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
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

    # a frame that pays its own warp-cache bake (a new pose, no memo)
    t0 = time.perf_counter()
    avatar.render_frame(state, frames[1], grid=grid, image_shape=(H, W))
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
        ngp_phase(dev, Path(work))
        # -- 13. the in-the-wild demo -------------------------------------
        demo = demo_phase(dev, Path(work))
        # -- 14. the data engine, MocapDataset, the triplane field --------
        data_phase(dev, Path(work))
        triplane_phase(dev, Path(work))
        # -- 15. the parallel layer -----------------------------------------
        par = {**dp_train_check(dev, Path(work)),
               **dp_render_check(dev, avatar, state, grid, batch,
                                 Path(work))["paths"],
               **multi_phase(dev, Path(work), cli)["paths"]}
    # -- 14. the eval modes on phase 4's avatar --------------------------------
    modes = modes_phase(dev, avatar, state, grid)

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
        "bound_by": head["bound_by"], "library_ms": head["library_ms"]}]}))
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
