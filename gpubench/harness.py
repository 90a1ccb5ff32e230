"""What every cell shares: finding a cell's files by the names in
BENCHMARK.json, the cache directories, the import check, the metric
readers and the judgement of the compared numbers.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration and
a traffic mix. Their files are found by name:

- `configs/<config>.json`: the game module, the weights file (or null for
  weights made from the seed), and the configuration as it is run;
- `traffic/<traffic>.json`: the generator that drives it (a module of
  `drivers/`), the keys it sets on the configuration, and its parameters;
- `limits/<workload>.json`: the limit of every number the cell's
  correctness check compares;
- `metrics/<metric>.py`: each per-layer metric's reader, a function
  `read(readings)` that returns the metric's value or None where the run
  has nothing for it to read.

So a configuration, a traffic mix, a cell or a per-layer metric is added by
adding files and BENCHMARK.json entries, without editing any file here.
"""

import importlib
import importlib.util
import json
import os
import pathlib
import sys
from typing import NamedTuple

BENCH_DIR = pathlib.Path(__file__).resolve().parent
# Build and kernel caches of the run, at fixed paths inside the checkout.
CACHE_DIR = BENCH_DIR / "_cache"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "muzero_general_tpu")


def set_cache_dirs():
    """Point every cache a run may fill at fixed directories inside the
    checkout, before torch or the program starts."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        path = CACHE_DIR / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def read_json(path):
    with open(path) as f:
        return json.load(f)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict  # the configuration file, its "config" with the traffic's keys set
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(entry, cell_name):
    """Whether a metric entry belongs to the cell: listed in its
    `workloads`, or, without the key, in every cell."""
    return cell_name in entry.get("workloads", [cell_name])


def load_cell(name, root=None, bench_dir=BENCH_DIR) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files."""
    root = pathlib.Path.cwd() if root is None else pathlib.Path(root)
    spec = read_json(root / "BENCHMARK.json")
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"gpubench: no workload {name!r} in BENCHMARK.json")
    work = entries[0]
    config = read_json(bench_dir / "configs" / f"{work['config']}.json")
    traffic = read_json(bench_dir / "traffic" / f"{work['traffic']}.json")
    limits = read_json(bench_dir / "limits" / f"{name}.json")
    merged = dict(config["config"])
    merged.update(traffic.get("config", {}))
    config = dict(config, config=merged)
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in spec["per_layer"] if _reports(m, name)]
    return Cell(name, work.get("chips", 1), config, traffic, limits, e2e, per_layer)


def load_reader(metric_name, bench_dir=BENCH_DIR):
    """The `read` function of metrics/<metric_name>.py."""
    path = bench_dir / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric_name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_driver(traffic):
    return importlib.import_module(f"gpubench.drivers.{traffic['generator']}")


def forbidden_loaded():
    """Modules of JAX or of the JAX package in this process, top-level
    names compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def read_metrics(entries, readings):
    """{name: {"value", "unit"}} of the entries whose reader finds a value."""
    out = {}
    for entry in entries:
        value = load_reader(entry["name"])(readings)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def judge(numbers, limits):
    """{name: {"value", "limit"}} for every compared number and whether all
    are within their limits (a number at or under its limit passes; a
    missing or non-finite one fails)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not (value == value) or value > limit:
            ok = False
    return checks, ok
