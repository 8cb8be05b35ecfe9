"""The readings that the limits in ``limits/<cell>.json`` are set from, in
one process for many seeds (set-up is long; one process pays the import
and the kernels' load once).

    python3 -m avatarbench.calibrate --workload <cell> --seeds a b c ...
        [--seconds 2] [--control-seeds n] [--out FILE]

For each seed: a short window of the cell as ``run`` drives it, then the
compared numbers of the program against the reference (the lower
reading). For the first ``--control-seeds`` seeds also the control (the
reference in the precision one step below the configuration's, put in the
program's place: TF32 operands for fp32, fp8 e4m3 for the head's bf16)
and the faults that the loop plants (its ``readings``), each against the
reference (the upper readings). One JSON line per reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import loops
from .run import cell_files, load_json, ROOT, set_caches


def readings(files: dict, seed: int, seconds: float, dev,
             controls: bool) -> list[dict]:
    cfg, tr = files["config"], files["traffic"]
    t0 = time.time()
    loop = loops.load(tr["loop"])
    run = loop.run(cfg, tr, seed, seconds, False, dev, t0)
    out = loop.readings(run, dev, controls)
    for r in out:
        r.update(seed=seed, setup_s=run.setup_s, wall_s=time.time() - t0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    files = cell_files(load_json(ROOT / "BENCHMARK.json"), args.workload)
    set_caches()
    import torch
    if not torch.cuda.is_available():
        print("avatarbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(args.seeds):
            for r in readings(files, seed, args.seconds, dev,
                              i < args.control_seeds):
                line = json.dumps({"workload": args.workload, **r},
                                  default=str)
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
