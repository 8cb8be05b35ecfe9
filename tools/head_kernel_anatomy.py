"""Where the fused field head's time goes on the card.

Builds ``instantavatar_torch/csrc/fused_head.cu`` three ways and times the
three in turns with CUDA events on the same inputs (flagship widths,
numpy-seeded, ``chip_smoke.head_inputs``):

  kernel    the source as it is;
  compute   without the input loads: the five layers run on whatever the
            shared-memory ring holds, and the outputs are stored;
  memory    without the five layers: the input tiles are loaded into the
            ring and read with ldmatrix, and the outputs are stored.

If ``compute`` takes nearly all of the kernel's time, the kernel is held
by instruction issue (mma.sync and the epilogues); if ``memory`` does, by
bytes. Prints one line per variant and a JSON line with the medians and
the byte bound (``chip_smoke.head_bound``).

Run from the repository root on a machine with an NVIDIA GPU and nvcc:
    python3 tools/head_kernel_anatomy.py [--rows N] [--reps R]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (numpy + torch; the head's inputs, timing)
from instantavatar_torch.kernels import fused_head  # noqa: E402

SOURCE = ROOT / "instantavatar_torch" / "csrc" / "fused_head.cu"
OUT_DIR = ROOT / "instantavatar_torch" / "_build" / "anatomy"

# the layers, from the first hidden fragments to the epilogue ...
LAYERS_FROM, LAYERS_TO = "    uint32_t a64[2][4][4];", "    // epilogue:"
# ... replaced by a use of the loaded fragments, so the loads stay
MEMORY_ONLY = """    float sig[2][2], o[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      sig[m][0] = __uint_as_float(x[m][0][0] ^ x[m][1][1]);
      sig[m][1] = __uint_as_float(x[m][0][2] ^ x[m][1][3]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[m][j] = __uint_as_float(x[m][2][j] ^ x[m][3][j & 1]);
    }
"""
LOADS = ("if (s < mine) load_tile(first + s * stride, s);",
         "if (ahead < mine) "
         "load_tile(first + ahead * stride, ahead % kStages);")


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    if name == "compute":
        for line in LOADS:
            if src.count(line) != 1:
                raise ValueError(f"{SOURCE.name} no longer holds: {line}")
            src = src.replace(line, "")
    elif name == "memory":
        i, j = src.index(LAYERS_FROM), src.index(LAYERS_TO)
        src = src[:i] + MEMORY_ONLY + src[j:]
    return src


def build(name: str):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(variant_source(name))
    proc = subprocess.run([fused_head._nvcc(), *fused_head.NVCC_FLAGS,
                           "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill stores" in ln]
    print(f"[anatomy] {name}: {'; '.join(regs)}")
    return fused_head._load(so)


def launcher(lib, args, dev):
    enc, (w0, w1), (b0, b1), (cw0, cw1, cw2), (cb0, cb1, cb2) = args
    M = enc.shape[0]
    color = torch.empty((M, 3), device=dev)
    sigma = torch.empty((M,), device=dev)
    ptrs = [t.data_ptr() for t in (enc, w0, b0, w1, b1, cw0, cb0, cw1, cb1,
                                   cw2, cb2, color, sigma)]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        rc = lib.fused_field_head_launch(*ptrs, M, 56, stream)
        if rc:
            err = lib.fused_field_head_error_string(rc).decode()
            raise RuntimeError(f"launch failed: {err}")
    return run


def main(rows: int, reps: int) -> int:
    if not torch.cuda.is_available():
        print("head_kernel_anatomy: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    args = chip_smoke.head_inputs(rows, 7, dev)
    fns = {name: launcher(build(name), args, dev)
           for name in ("kernel", "compute", "memory")}
    for _ in range(3):
        for fn in fns.values():
            fn()
    ms = {name: [] for name in fns}
    for _ in range(reps):
        for name in ("kernel", "compute", "memory", "memory", "compute",
                     "kernel"):
            ms[name] += chip_smoke.cuda_ms(fns[name], 1)
    bound, by = chip_smoke.head_bound(rows)
    med = {name: statistics.median(v) for name, v in ms.items()}
    for name, t in med.items():
        print(f"[anatomy] {name}: {t:.4f} ms at M={rows} (median of "
              f"{len(ms[name])}), {100 * t / med['kernel']:.1f}% of the "
              f"kernel's time, bound {bound:.4f} ms ({by})")
    print(json.dumps({"rows": rows, "ms": med, "bound_ms": bound,
                      "bound_by": by}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_500_000)
    ap.add_argument("--reps", type=int, default=8)
    a = ap.parse_args()
    sys.exit(main(a.rows, a.reps))
