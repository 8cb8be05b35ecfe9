"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m avatarbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix and
limits are found by name (``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json``), the loop that the
traffic file names as ``loops/<loop>.py``, each metric's reader as
``metrics/<metric>.py``. With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics. Without as
many CUDA devices as the cell asks for, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "instantavatar_tpu")


def process_start() -> float:
    """This process's start, as a ``time.time()`` value (Linux /proc)."""
    ticks = os.sysconf("SC_CLK_TCK")
    start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                .split()[19]) / ticks
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return time.time() - (uptime - start)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    libraries' or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(manifest: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic mix and limits, by name."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return {"cell": cell,
            "config": load_json(ROOT / configs[cell["config"]]["file"]),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json")}


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "avatarbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list[dict]:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key]
            if workload in m.get("workloads", [workload])]


def set_caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds
    into ``instantavatar_torch/_build/`` by itself)."""
    cache = ROOT / ".avatarbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv: list[str] | None = None) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    files = cell_files(manifest, args.workload)
    chips = files["cell"]["chips"]
    set_caches()

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"avatarbench: the cell needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one host thread for PyTorch's CPU ops: the load of one process with
    # few threads, which the window's host clock reads steadier
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)

    result = measure(manifest, files, args.workload, args.seed,
                     args.seconds, bool(args.trace), dev, t_process)
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


def measure(manifest: dict, files: dict, workload: str, seed: int,
            seconds: float, trace: bool, dev, t_process: float
            ) -> dict | None:
    """Everything of a run after the look for a device: set-up, window,
    metrics, the comparison with the reference. Returns the result line's
    object, its compared numbers last; None (and a note on standard
    error) when JAX or the JAX package got loaded."""
    import torch
    from . import loops
    tr = files["traffic"]
    loop = loops.load(tr["loop"])
    run = loop.run(files["config"], tr, seed, seconds, trace, dev, t_process)
    metrics = {}
    for m in cell_metrics(manifest, workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = loop.numbers(run, dev)
    found = forbidden_modules()
    if found:
        print(f"avatarbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return None
    limits = files["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": files["cell"]["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    extra = {k: v for k, v in numbers.items() if k.startswith("_")}
    extra.update(run.notes)
    print(f"avatarbench: {workload} seed {seed}: {json.dumps(extra)}",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
