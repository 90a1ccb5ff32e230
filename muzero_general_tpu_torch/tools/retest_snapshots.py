"""Offline strength retest of numbered training snapshots on the card (port
of tools/retest_snapshots.py).

For every model_<step>.checkpoint under --dir (connect4_gate's `--snapshot`
writes them), plays --games greedy evaluation games against --opponent
(default the connect4 expert) through evaluate.play_against_opponent and
prints one table row per snapshot: the offline counterpart of the in-run
muzero_reward curve, apart from self-play and the in-run evaluation's
noise.

Usage (on the card; `--device cpu` runs it on the CPU):
    python -m muzero_general_tpu_torch.tools.retest_snapshots --dir DIR \\
        [--games 20] [--game connect4] [--opponent expert] [--also-final]

Prints the card's name and power limit, then the JAX tool's markdown table
(snapshot, mean reward, wins/games, losses, draws). In a two-player game
the reward is MuZero's own (two_player_reward_split), never negative, so
a lost game counts under draws, as in the JAX tool.
"""

import argparse
import pathlib
import re

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.tools import profiling


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--game", default="connect4")
    ap.add_argument("--games", type=int, default=20)
    ap.add_argument("--opponent", default="expert")
    ap.add_argument("--also-final", action="store_true",
                    help="include the rolling model.checkpoint as a row")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(profiling.card_line(device))

    import numpy as np

    from muzero_general_tpu_torch.evaluate import play_against_opponent
    from muzero_general_tpu_torch.models import params_from_jax
    from muzero_general_tpu_torch.muzero import MuZero, two_player_reward_split

    d = pathlib.Path(args.dir)
    snaps = sorted(
        d.glob("model_*.checkpoint"),
        key=lambda p: int(re.search(r"model_(\d+)", p.name).group(1)),
    )
    if args.also_final and (d / "model.checkpoint").exists():
        snaps.append(d / "model.checkpoint")
    if not snaps:
        raise SystemExit(f"no model_*.checkpoint under {d}")

    mz = MuZero(args.game, {"results_path": str(d / "retest")}, device=device)
    cfg = mz.config
    env = mz.make_env()
    print("\n| snapshot | mean reward | wins/games | losses | draws |")
    print("|---|---:|---:|---:|---:|")
    for snap in snaps:
        mz.load_model(checkpoint_path=snap)
        mz.network.load_state_dict(params_from_jax(mz.checkpoint["weights"]))
        rewards = []
        for i in range(args.games):
            gh = play_against_opponent(
                env, mz.network, cfg, args.opponent,
                cfg.muzero_player, seed=cfg.seed + 1000 + i,
            )
            if len(cfg.players) == 1:
                rewards.append(float(gh.rewards.sum()))
            else:
                rewards.append(two_player_reward_split(gh, cfg.muzero_player)[0])
        r = np.asarray(rewards)
        print(
            f"| {snap.name} | {r.mean():+.2f} | "
            f"{int((r > 0).sum())}/{len(r)} | {int((r < 0).sum())} | "
            f"{int((r == 0).sum())} |",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
