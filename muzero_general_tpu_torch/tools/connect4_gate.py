"""Connect4 learning gate on the card (port of tools/connect4_gate.py).

Trains the shipped connect4 config (the 3 x 64 ResNet, 200 simulations, the
expert-opponent evaluation game in the train loop) for a bounded budget and
reports the muzero-vs-expert reward trend from metrics.jsonl: the mean
`muzero_reward` per quartile of training steps. That is MuZero's own
reward in each evaluation game against the expert (connect4 pays the
winning move 10, so 10 for a win, 0 for a loss or a draw), as in the JAX
tool. The bar, as the JAX tool's: that reward trending up over the run.

Usage (on the card; `--device cpu` runs it on the CPU):
    python -m muzero_general_tpu_torch.tools.connect4_gate [--steps 4000] \\
        [--ratio 0.35] [--games 256] [--out DIR] [--batch-leaves 1] \\
        [--seed 0] [--snapshot N] [--override JSON] [--fresh]
Stop early with: touch <out>/STOP   (graceful, final checkpoint kept)

Prints the card's name and power limit, the run's steps, wall and games,
then the JAX tool's markdown table (step quartile, mean muzero_reward vs
expert, evals) and the checkpoint's path.
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--ratio", type=float, default=0.35)
    ap.add_argument("--games", type=int, default=256)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "c4_gate"))
    ap.add_argument("--batch-leaves", type=int, default=1,
                    help="search_batch_leaves for the K>1 learning check")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snapshot", type=int, default=None,
                    help="keep model_<step>.checkpoint every N steps "
                    "(per-decile regression diagnosis)")
    ap.add_argument("--override", default=None,
                    help="extra config overrides as a JSON dict "
                    "(intervention runs, e.g. '{\"PER\": false}')")
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(profiling.card_line(device))

    from muzero_general_tpu_torch.muzero import MuZero

    out = pathlib.Path(args.out)
    if args.fresh:
        shutil.rmtree(out, ignore_errors=True)

    mz = MuZero(
        "connect4",
        {
            "training_steps": args.steps,
            "parallel_games": args.games,
            # The shipped config's ratio is None (train 1:1 with played
            # steps), which on one card starves self-play; the gate uses a
            # fixed train:act ratio, as the JAX tool.
            "ratio": args.ratio,
            "results_path": str(out),
            "compute_dtype": "bfloat16",
            # One eval game vs the expert per outer loop: a dense
            # muzero_reward curve.
            "eval_interval_loops": 1,
            "search_batch_leaves": args.batch_leaves,
            "seed": args.seed,
            "snapshot_interval": args.snapshot,
            **(json.loads(args.override) if args.override else {}),
        },
        device=device,
    )
    t0 = time.time()
    ck = mz.train(log_in_tensorboard=True)
    wall = time.time() - t0

    rows = []
    for line in open(out / "metrics.jsonl"):
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "muzero_reward" in r and "training_step" in r:
            rows.append(r)

    # Mean muzero-vs-expert reward per training-step quartile.
    steps = ck["training_step"]
    print(f"\nConnect4 gate: {steps} steps, {wall/60:.1f} min wall, "
          f"{ck['num_played_games']} games played")
    print("\n| step quartile | mean muzero_reward vs expert | evals |")
    print("|---|---:|---:|")
    q = max(1, steps // 4)
    for i in range(4):
        lo, hi = i * q, (i + 1) * q
        vals = [r["muzero_reward"] for r in rows if lo <= r["training_step"] < hi]
        if vals:
            print(f"| {lo}-{hi} | {sum(vals)/len(vals):+.3f} | {len(vals)} |")
    print(f"\ncheckpoint: {out}/model.checkpoint")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
