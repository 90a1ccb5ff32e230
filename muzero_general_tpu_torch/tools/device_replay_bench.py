"""The device-replay train loop against host replay, on the card (port of
tools/device_replay_bench.py).

Runs connect4's shipped config twice for a bounded step budget, host replay
(the baseline) and `device_replay` (ops/device_replay.py: the game ring on
the card, PER sampling, batch assembly, M train steps and the priority
write-back in one round), both at bfloat16 with the prefetcher off, and
reports the per-phase wall clock (muzero.py's `phase_time_s` records in
metrics.jsonl, the totals of its `loop.*` spans, written every loop and
once at the end) and the total wall.

Usage (on the card; `--device cpu` runs it on the CPU):
    python -m muzero_general_tpu_torch.tools.device_replay_bench \\
        [--steps 3000] [--games 256] [--ratio 0.35] [--out DIR]

Prints the card's name and power limit, then the JAX tool's markdown table
(path, steps, games, wall s, train s, batch s, selfplay s).
"""

import argparse
import json
import os
import pathlib
import shutil
import tempfile
import time

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.tools import profiling


def run_one(device_replay, steps, games, ratio, out, device=None):
    from muzero_general_tpu_torch.muzero import MuZero

    shutil.rmtree(out, ignore_errors=True)
    mz = MuZero(
        "connect4",
        {
            "training_steps": steps,
            "parallel_games": games,
            "ratio": ratio,
            "results_path": str(out),
            "compute_dtype": "bfloat16",
            "device_replay": device_replay,
            # The device path samples on the card; the host prefetcher is off
            # in BOTH runs so the comparison is the synchronous loop.
            "batch_prefetch": False,
        },
        device=device,
    )
    t0 = time.time()
    ck = mz.train(log_in_tensorboard=True)
    wall = time.time() - t0

    phases = None
    for line in open(pathlib.Path(out) / "metrics.jsonl"):
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "phase_time_s" in r:
            phases = r["phase_time_s"]  # cumulative; keep the last record
    return {
        "device_replay": device_replay,
        "steps": ck["training_step"],
        "games": ck["num_played_games"],
        "wall_s": round(wall, 1),
        "phases": {k: round(v, 1) for k, v in (phases or {}).items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--games", type=int, default=256)
    ap.add_argument("--ratio", type=float, default=0.35)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "devrep_bench"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(profiling.card_line(device))

    rows = [
        run_one(False, args.steps, args.games, args.ratio, args.out + "_host", device),
        run_one(True, args.steps, args.games, args.ratio, args.out + "_dev", device),
    ]
    print("\n| path | steps | games | wall s | train s | batch s | "
          "selfplay s |")
    print("|---|---:|---:|---:|---:|---:|---:|")
    for r in rows:
        p = r["phases"]
        print(
            f"| {'device' if r['device_replay'] else 'host'} | {r['steps']} "
            f"| {r['games']} | {r['wall_s']} | {p.get('train', 0)} "
            f"| {p.get('batch', 0)} | {p.get('selfplay', 0)} |"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
