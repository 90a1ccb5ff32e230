"""Gumbel against pUCT at matched training budgets, on the card (port of
tools/gumbel_proof.py).

Trains a game end to end (default cartpole) with the shipped 50-simulation
pUCT config and with Gumbel root selection (ops/gumbel.py) at 16 and 8
simulations per move, the same number of training steps each, then takes
each run's greedy test reward over `--tests` games and its wall clock.
Gumbel's claim (Danihelka et al., ICLR 2022): the same policy improvement
with far fewer simulations, so the 16- and 8-simulation rows should match
the 50-simulation row's reward at a fraction of the search cost. `--seeds
N` runs every config at seeds 0..N-1 and reports the mean +/- (max-min)/2.

Usage (on the card; `--device cpu` runs it on the CPU):
    python -m muzero_general_tpu_torch.tools.gumbel_proof [--steps 7500] \\
        [--game cartpole] [--tests 10] [--seeds 1] [--opponent random] \\
        [--configs puct,gumbel16,gumbel8]

Prints the card's name and power limit, then the JAX tool's markdown table
(search, sims/move, mean test reward, per-seed, mean wall).
"""

import argparse
import time

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.tools import profiling


def run(game, overrides, num_tests, label, seeds=1, opponent=None, device=None):
    from muzero_general_tpu_torch.muzero import MuZero

    scores, wall = [], 0.0
    sims = None
    for seed in range(seeds):
        t0 = time.time()
        mz = MuZero(game, dict(overrides, seed=seed), device=device)
        mz.train(log_in_tensorboard=False)
        wall += time.time() - t0
        scores.append(mz.test(num_tests=num_tests, opponent=opponent))
        sims = mz.config.num_simulations
    return {
        "label": label,
        "scores": scores,
        "score": sum(scores) / len(scores),
        "spread": (max(scores) - min(scores)) / 2,
        "wall_s": wall / seeds,
        "sims": sims,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=7500)
    ap.add_argument("--game", default="cartpole")
    ap.add_argument("--tests", type=int, default=10)
    ap.add_argument("--out", default=None, help="results path prefix (unused, as in JAX's)")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--opponent", default=None,
                    help="test-time opponent override (e.g. random/expert); "
                    "default = the game config's opponent")
    ap.add_argument("--configs", default="puct,gumbel16,gumbel8",
                    help="comma list of rows to run")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(profiling.card_line(device))

    base = {
        "training_steps": args.steps,
        "save_model": False,
    }
    configs = args.configs.split(",")
    rows = []
    if "puct" in configs:
        rows.append(
            run(args.game, {**base}, args.tests, "pUCT (shipped config)",
                seeds=args.seeds, opponent=args.opponent, device=device)
        )
    for sims in (16, 8):
        if f"gumbel{sims}" not in configs:
            continue
        rows.append(
            run(
                args.game,
                {
                    **base,
                    "use_gumbel_mcts": True,
                    "num_simulations": sims,
                    "gumbel_max_considered_actions": min(sims, 16),
                },
                args.tests,
                f"Gumbel {sims} sims",
                seeds=args.seeds,
                opponent=args.opponent,
                device=device,
            )
        )

    print(f"\n| Search | sims/move | mean test reward ({args.tests} games"
          f" x {args.seeds} seeds) | per-seed | mean wall |")
    print("|---|---:|---:|---:|---:|")
    for r in rows:
        per = ", ".join(f"{x:.0f}" for x in r["scores"])
        print(
            f"| {r['label']} | {r['sims']} | {r['score']:.1f} "
            f"+/- {r['spread']:.1f} | {per} | {r['wall_s']:.0f} s |"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
