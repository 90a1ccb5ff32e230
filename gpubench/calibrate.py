"""Readings that the limits of a cell's correctness check are set from, in
one process: for each seed a run of the cell with a short window (one call
after the warm-up), the program's compared numbers, and on the first
`--control-seeds` seeds the control's: the reference put in the program's
place in the precision below the configuration's (float32 -> TF32,
bfloat16 -> float8), and for training the planted fault of a step that
leaves half of its batch out.

    python3 -m gpubench.calibrate --workload <name> --seeds 1,2,3 [--control-seeds 3]

On the card. Prints one JSON line a seed.
"""

import argparse
import json
import sys
import time

from gpubench import harness

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    cell = harness.load_cell(args.workload)
    driver = harness.load_driver(cell.traffic)
    control = CONTROL[cell.config["config"]["compute_dtype"]]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = driver.run(cell, seed % 2**63, 0.0, False, torch.device("cuda", 0),
                         t_start if i == 0 else t0,
                         control=control if i < args.control_seeds else None)
        print(json.dumps({"workload": cell.name, "seed": seed, "numbers": out["numbers"],
                          "control": control if "control_numbers" in out else None,
                          "control_numbers": out.get("control_numbers"),
                          "fault_numbers": out.get("fault_numbers"), "failed": out["failed"],
                          "end_to_end": out["end_to_end"], "setup_s": out["setup_s"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
