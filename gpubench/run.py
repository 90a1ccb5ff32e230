"""Run one cell of the port's benchmark once and print its result.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (BENCHMARK.json names the cells). The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device`, with --trace 1 `breakdown`,
and last `checks`, each compared number beside its limit; the same
numbers end standard error, after a line with each window call's seconds. Without a CUDA card, or with fewer cards than
the cell asks for, it prints no result and exits 2; it exits 3 and prints
no result if JAX or the JAX package was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from gpubench import harness  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, out, trace, device_info):
    """The contract's result object; `checks` comes last."""
    checks, ok = harness.judge(out["numbers"], cell.limits["limits"])
    correct = ok and out["failed"] == 0
    if trace:
        metrics = harness.read_metrics(cell.per_layer, out["readings"])
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = dict(device_info, memory_peak_bytes=out["memory_peak_bytes"], **out["device"])
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if trace and out["breakdown"] is not None:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


def run_cell(cell, seed, seconds, trace, device, t_start):
    """The generator's run of the cell (see drivers/)."""
    return harness.load_driver(cell.traffic).run(cell, seed, seconds, trace, device, t_start)


def main(argv=None):
    args = parse_args(argv)
    harness.set_cache_dirs()
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    seed = args.seed % 2**63
    out = run_cell(cell, seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"gpubench: the run imported {', '.join(found)}; no result", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    line = result_line(cell, out, bool(args.trace), info)
    if out.get("note"):
        print(out["note"], file=sys.stderr)
    walls = [c["wall_s"] for c in out["readings"]["calls"] if not c["profiled"]]
    print(f"gpubench window: {len(walls)} calls, each call's seconds "
          f"{' '.join(f'{w:.4f}' for w in walls)}", file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"gpubench check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
