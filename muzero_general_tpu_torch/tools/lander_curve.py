"""Deterministic against stochastic LunarLander learning curves (port of
tools/lander_curve.py).

The reference ships a lander with its engine dispersion zeroed, as a
deterministic transition model helps MuZero's learned dynamics; the port's
envs/host.py `LunarLander(deterministic=True|False)` has both engines. This
tool trains the shipped config under each at a matched budget, reads the
greedy evaluation lane's reward from metrics.jsonl, and prints the learning
curve at four training-step milestones and a final fresh test().

It needs gymnasium with Box2D (envs/host.py imports it when the env is
made, and raises its ImportError where it is missing, as on a card machine
without it).

Usage (`--device cpu` runs it on the CPU):
    python -m muzero_general_tpu_torch.tools.lander_curve [--steps 12000] \\
        [--tests 5] [--seeds 1]

Prints the card's name and power limit, then the JAX tool's markdown table
(engine, the reward at each milestone, final test mean, per-seed, wall).
"""

import argparse
import json
import pathlib
import shutil
import tempfile
import time

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.tools import profiling


def run(deterministic, steps, tests, seed=0, device=None):
    from muzero_general_tpu_torch.games import lunarlander
    from muzero_general_tpu_torch.muzero import MuZero

    tag = "det" if deterministic else "stoch"
    results = pathlib.Path(tempfile.gettempdir()) / f"lander_curve_{tag}"
    shutil.rmtree(results, ignore_errors=True)
    mz = MuZero(
        "lunarlander",
        {
            "training_steps": steps,
            "save_model": False,
            "seed": seed,
            "results_path": str(results),
        },
        device=device,
    )
    # The engine knob is make_env's, not the config's (envs/host.py). Keep
    # the seed keyword: HostSelfPlayDriver calls env_factory(seed=...) per
    # lane (hostplay.py).
    mz.make_env = lambda seed=None: lunarlander.make_env(
        seed=seed, deterministic=deterministic
    )
    t0 = time.time()
    mz.train(log_in_tensorboard=True)
    wall = time.time() - t0
    final = mz.test(num_tests=tests)

    rows = [
        json.loads(line)
        for line in open(results / "metrics.jsonl")
        if "training_step" in line
    ]
    rows = [r for r in rows if "total_reward" in r]
    return rows, final, wall


def curve_at(rows, milestones):
    """Greedy-lane reward at each training-step milestone (last value <= m)."""
    out = []
    for m in milestones:
        vals = [r["total_reward"] for r in rows if r["training_step"] <= m]
        out.append(vals[-1] if vals else float("nan"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--tests", type=int, default=5)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(profiling.card_line(device))

    milestones = [args.steps // 4 * (i + 1) for i in range(4)]
    table = []
    for det in (True, False):
        label = "deterministic (reference engine)" if det else "stochastic"
        curves, finals, walls = [], [], 0.0
        for seed in range(args.seeds):
            rows, final, wall = run(det, args.steps, args.tests, seed=seed, device=device)
            curves.append(curve_at(rows, milestones))
            finals.append(final)
            walls += wall
        mean_curve = [sum(c[i] for c in curves) / len(curves)
                      for i in range(len(milestones))]
        table.append((label, mean_curve, finals, walls / args.seeds))

    header = " | ".join(f"@{m}" for m in milestones)
    print(f"\n| Engine | {header} | final test mean ({args.tests} games"
          f" x {args.seeds} seeds) | per-seed | wall |")
    print("|---|" + "---:|" * (len(milestones) + 3))
    for label, curve, finals, wall in table:
        cells = " | ".join(f"{c:.1f}" for c in curve)
        mean_f = sum(finals) / len(finals)
        spread = (max(finals) - min(finals)) / 2
        per = ", ".join(f"{x:.0f}" for x in finals)
        print(f"| {label} | {cells} | {mean_f:.1f} +/- {spread:.1f} "
              f"| {per} | {wall:.0f} s |")
    print("\n(milestone cols: greedy-lane reward averaged over seeds, "
          "reward/3 scale as the reference's config)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
