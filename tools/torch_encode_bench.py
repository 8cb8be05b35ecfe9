"""Time the port's hash-encode kernel beside another build of its source
(an earlier ``csrc/hash_encode.cu`` with the same C interface), in turns
on one card: ``chip_smoke.encode_timing`` with both builds, on the largest
``hash_encode`` call of the NGP train CLI's steps and of an ``animate``
frame, made as ``chip_smoke.py`` phase 12 makes them (a 264 px capsule
sequence, ``SNARF_NGP`` for CLI_EPOCHS epochs, the 6-pose animate at 540
px).

    python3 tools/torch_encode_bench.py OLD.cu

Needs one CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def path_points(dev, work: Path) -> dict[str, torch.Tensor]:
    """The largest encode call of the NGP train CLI's steps and of an
    animate frame, on a fresh capsule sequence in ``work``."""
    import chip_smoke as cs
    from instantavatar_torch.cli import animate, train
    from instantavatar_torch.data import make_synthetic_sequence
    n = cs.CLI_TRAIN + cs.CLI_VAL + cs.CLI_TEST
    seq = make_synthetic_sequence(work / "seq", n_frames=n, H=cs.CLI_SIZE,
                                  W=cs.CLI_SIZE, style="capsule", device=dev)
    over = cs.cli_overrides(seq, work / "run")
    _, train_x, stop = cs._count_encode(steps_only=True)
    train.main(["--config-name", "SNARF_NGP",
                f"train.max_epochs={cs.CLI_EPOCHS}",
                f"train.check_val_every_n_epoch={cs.CLI_EPOCHS}", *over])
    stop()
    cs.write_poses(work / "poses.npz")
    _, anim_x, stop = cs._count_encode()
    animate.main(["--config-name", "SNARF_NGP",
                  f"+pose_sequence={work / 'poses.npz'}",
                  "+render_downscale=2", *over])
    stop()
    return {"train_step_call": train_x["x"],
            "animate_frame_call": anim_x["x"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("baseline", type=Path,
                    help="another hash_encode.cu to build and time beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_encode_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import instantavatar_torch.kernels.hash_encode as kmod
    from instantavatar_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(2) as pool:
        ours = pool.submit(kmod.build_hash_library)
        base = pool.submit(build.nvcc_build, "hash_encode_baseline",
                           (args.baseline.resolve(),), kmod._load)
        builds = {"kernel": ours.result(), "baseline": base.result()}
    for k, info in builds.items():
        print(f"[build] {k}: {info.path.name} {info.seconds:.1f} s")
    with tempfile.TemporaryDirectory(prefix="encode_bench_") as work:
        points = path_points(dev, Path(work))
    cs.encode_timing(dev, points, {"baseline": builds["baseline"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
