"""One run of one cell of the port's benchmark (``BENCHMARK.json``).

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card.  The run
builds (or loads) the port's kernel library in ``build/art_tpu_torch/``,
makes its inputs from the seed, warms the cell's shapes, calls into the
engine for ``--seconds`` and waits for the device, then compares what the
window produced with the configuration's plain reference.  Its last line
on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
which are also the last lines of standard error.

Without a card it exits with 2 and prints no result.  ``--rehearse`` runs
the same flow on the CPU, with the kernels' plain versions, at the cell's
tiny ``rehearse`` sizes; its device reads ``cpu``.  ``--control 1`` puts
the TF32 control in the program's place in the check (``checks.py``), so
that the run has to come out not correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / "bench_torch" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "art_tpu")


def _load(path: Path) -> dict:
    return json.loads(path.read_text())


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    bench = _load(ROOT / "BENCHMARK.json")
    cell_of = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cell_of:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    wl = cell_of[args.workload]
    cell = _load(HERE / "cells" / f"{args.workload}.json")
    config = _load(HERE / "configs" / f"{wl['config']}.json")
    if cell["config"] != wl["config"] or cell["traffic"] != wl["traffic"]:
        raise SystemExit(f"cells/{args.workload}.json disagrees with "
                         "BENCHMARK.json")
    traffic = dict(cell["traffic_params"])

    import torch
    if args.rehearse:
        device = torch.device("cpu")
        config = {**config, **cell["rehearse"].get("config", {})}
        traffic.update(cell["rehearse"].get("traffic", {}))
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
                  "torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)

    from bench_torch import harness
    entry_mod = importlib.import_module(f"bench_torch.entries.{cell['entry']}")
    entry = entry_mod.Entry(harness.Context(config, traffic, args.seed,
                                            device))
    entry.setup()
    entry.warmup()
    entry.sync()
    run = harness.Run(entry, time.perf_counter() - T_START)
    harness.window(run, args.seconds, bool(args.trace))
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if _applies(m, args.workload):
            value = harness.read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    entry.release()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = entry.check(bool(args.control))
    t_check = time.perf_counter() - t_check
    checks = {name: {"value": value, "limit": cell["limits"][name]}
              for name, value in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"the run imported {', '.join(loaded)}", file=sys.stderr)
        return 1
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": wl["chips"],
        "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.calls, "failed": 0,
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    sys.stdout.flush()
    print(f"the check took {t_check:.3f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
