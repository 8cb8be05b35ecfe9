"""Fused canonical-field head: the hand-written CUDA kernel
(``csrc/fused_head.cu``), its build and ctypes binding, and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``instantavatar_tpu/ops/fused_head.py``
(``fused_field_head``). Dispatch is by the device of ``enc``: a CPU tensor
goes to ``fused_field_head_ref``; a CUDA tensor goes to the kernel, or
the call raises. There is no silent fallback from one to the other.

The kernel library is built at first use with ``nvcc`` (sm_90a) from the
sources in this package into ``instantavatar_torch/_build/``, keyed by a
hash of the sources and flags, so later processes reuse it.

Launch configuration: a persistent grid of (SMs x resident blocks) blocks
of 4 warps, each warp walking 32-row tiles with a grid stride; the grid
is sized once per device in ``csrc/fused_head.cu`` from the occupancy
API, and ``head_wave_rows`` reports the rows one pass of it covers.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

__all__ = ["fused_field_head", "fused_field_head_ref", "build_library",
           "BuildInfo", "head_cost", "head_wave_rows"]

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "fused_head.cu",)
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_SIGMA_DIMS = ((None, 64), (64, 16))           # E -> 64 -> 16
_COLOR_DIMS = ((15, 64), (64, 64), (64, 3))    # 15 -> 64 -> 64 -> 3

_NO_GRAD_MSG = ("the fused field head is forward-only on CUDA: call it "
                "under torch.no_grad(), or train through the _mlp head "
                "(VoxelTriplaneField.apply(..., head=\"mlp\")), as JAX does")


class BuildInfo(NamedTuple):
    path: Path          # the shared library
    seconds: float      # nvcc wall time (0.0 when reused)
    reused: bool        # True if an identical build was found
    log: str            # nvcc / ptxas output (-Xptxas -v), empty if reused
    lib: ctypes.CDLL


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin); the CUDA toolkit is needed "
                           "to build the fused field head")
    return str(path)


@functools.lru_cache(maxsize=None)
def build_library() -> BuildInfo:
    """Build (or reuse) and load the kernel library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        digest.update(src.read_bytes())
    path = _BUILD_DIR / f"fused_head_{digest.hexdigest()[:16]}.so"
    seconds, log, reused = 0.0, "", path.exists()
    if not reused:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
    return BuildInfo(path, seconds, reused, log, _load(path))


def _load(path: Path) -> ctypes.CDLL:
    """Load a build of ``csrc/fused_head.cu`` and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    lib.fused_field_head_launch.argtypes = \
        [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    lib.fused_field_head_launch.restype = ctypes.c_int
    lib.fused_field_head_supports.argtypes = [ctypes.c_int]
    lib.fused_field_head_supports.restype = ctypes.c_int
    lib.fused_field_head_wave_rows.argtypes = [ctypes.c_int]
    lib.fused_field_head_wave_rows.restype = ctypes.c_int
    lib.fused_field_head_error_string.argtypes = [ctypes.c_int]
    lib.fused_field_head_error_string.restype = ctypes.c_char_p
    return lib


def head_cost(M: int, E: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the head on M rows of width E: the multiply-adds
    of the five layers, and each row's bf16 input read once and its fp32
    colour and sigma written once. The ~20 KB of weights, read once per
    call, are left out (0.01% of the bytes at 1.5M rows)."""
    macs = sum((din or E) * dout for din, dout in _SIGMA_DIMS + _COLOR_DIMS)
    return 2 * macs * M, (2 * E + 4 * 4) * M


def head_wave_rows(device, E: int = 56) -> int:
    """Rows that one pass of the kernel's persistent grid covers on the
    CUDA ``device`` (blocks x 4 warps x 32 rows)."""
    info = build_library()
    with torch.cuda.device(device):
        n = info.lib.fused_field_head_wave_rows(E)
    if n <= 0:
        err = info.lib.fused_field_head_error_string(-n).decode()
        raise RuntimeError(f"fused_field_head: no launch configuration: {err}")
    return n


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16-rounded operands, fp32 products and accumulation."""
    return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def fused_field_head_ref(enc: torch.Tensor, sigma_w, sigma_b, color_w,
                         color_b) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, same semantics: bf16 operands,
    fp32 accumulation, fp32 hidden bias before the ReLU and bf16 cast,
    fp32 output layers. Returns (color (M, 3), sigma (M,))."""
    w0, w1 = sigma_w
    b0, b1 = sigma_b
    cw0, cw1, cw2 = color_w
    cb0, cb1, cb2 = color_b
    h = torch.relu(_dot(enc, w0) + b0.float())
    geo = _dot(h, w1) + b1.float()
    c = torch.relu(_dot(geo[:, 1:16], cw0) + cb0.float())
    c = torch.relu(_dot(c, cw1) + cb1.float())
    c = torch.sigmoid(_dot(c, cw2) + cb2.float())
    return c, geo[:, 0]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def fused_field_head(enc: torch.Tensor, sigma_w, sigma_b, color_w, color_b
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, E) encoded features -> (color (M, 3) f32, sigma (M,) f32).

    CPU tensors run ``fused_field_head_ref``. CUDA tensors launch the
    kernel and must be: ``enc`` bf16 (M, E); weights bf16 (E, 64),
    (64, 16), (15, 64), (64, 64), (64, 3); biases f32; all contiguous and
    on one device; autograd off. Anything else raises.
    """
    if enc.device.type == "cpu":
        return fused_field_head_ref(enc, sigma_w, sigma_b, color_w, color_b)
    if enc.device.type != "cuda":
        raise ValueError(f"fused_field_head: unsupported device {enc.device}")
    tensors = (enc, *sigma_w, *sigma_b, *color_w, *color_b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(_NO_GRAD_MSG)
    if enc.dim() != 2:
        raise ValueError(f"enc must be (M, E), got {tuple(enc.shape)}")
    M, E = enc.shape
    info = build_library()
    if not info.lib.fused_field_head_supports(E):
        raise ValueError(f"fused_field_head: encoder width {E} is not "
                         f"compiled into csrc/fused_head.cu")
    dev = enc.device
    _check("enc", enc, torch.bfloat16, (M, E), dev)
    for i, ((din, dout), w, b) in enumerate(zip(_SIGMA_DIMS, sigma_w,
                                                sigma_b)):
        _check(f"sigma_w[{i}]", w, torch.bfloat16, (din or E, dout), dev)
        _check(f"sigma_b[{i}]", b, torch.float32, (dout,), dev)
    for i, ((din, dout), w, b) in enumerate(zip(_COLOR_DIMS, color_w,
                                                color_b)):
        _check(f"color_w[{i}]", w, torch.bfloat16, (din, dout), dev)
        _check(f"color_b[{i}]", b, torch.float32, (dout,), dev)
    color = torch.empty((M, 3), dtype=torch.float32, device=dev)
    sigma = torch.empty((M,), dtype=torch.float32, device=dev)
    if M == 0:
        return color, sigma
    (w0, w1), (b0, b1) = sigma_w, sigma_b
    (cw0, cw1, cw2), (cb0, cb1, cb2) = color_w, color_b
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = info.lib.fused_field_head_launch(
            enc.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), cw0.data_ptr(), cb0.data_ptr(), cw1.data_ptr(),
            cb1.data_ptr(), cw2.data_ptr(), cb2.data_ptr(),
            color.data_ptr(), sigma.data_ptr(), M, E, stream)
    if rc != 0:
        raise RuntimeError(
            "fused_field_head launch failed: "
            f"{info.lib.fused_field_head_error_string(rc).decode()}")
    fused_field_head.launches += 1
    fused_field_head.rows += M
    return color, sigma


# launch counters: kernel launches and rows through the kernel
fused_field_head.launches = 0
fused_field_head.rows = 0
