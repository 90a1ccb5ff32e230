"""Trace one board-game search move on the card and print the top device ops
by total time (port of tools/trace_search.py).

One `run_mcts` move of `--games` lanes x `--sims` simulations from zero
observations, all actions legal, the game's network with seeded random
weights (seed 0), is run once to warm up, once unprofiled (the wall time the
busy share is taken against) and once under torch.profiler. The raw trace
events are summed by kernel name (tools/profiling.py).

`--pallas 1` takes the kernel route SearchSpec.from_config chooses for the
game at this width: the planar descent and backprop kernels
(csrc/mcts_kernels.cu) where the tree fits them, else the stream kernels
(csrc/mcts_stream.cu, gomoku); `--pallas 0` the plain-op route (the
descent and backprop in PyTorch ops), the counterpart of JAX's XLA path.
`--fold 1` searches with the batch norms folded into the convs, as
self-play does.

Usage (on the card; `--device cpu` checks the plumbing on the CPU):
    python -m muzero_general_tpu_torch.tools.trace_search [--game connect4] \\
        [--games 256] [--sims 200] [--pallas 1] [--fold 0] [--batch-leaves 1] \\
        [--top 40] [--keep DIR]

Prints the card's name and power limit, the route and the kernels' launch
counts, then JAX's table: total device op time, then one row per kernel name
(ms, launches, us per launch, name), plus the launches per simulation and
the card's busy share of the unprofiled move.
"""

import argparse
import sys

import torch

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.tools import profiling


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--game", default="connect4",
                    help="game module for config (connect4, gomoku, tictactoe, twentyone, "
                         "breakout, ...)")
    ap.add_argument("--games", type=int, default=256)
    ap.add_argument("--sims", type=int, default=200)
    ap.add_argument("--pallas", type=int, default=1,
                    help="1: the kernel route (planar or stream); 0: the plain-op route")
    ap.add_argument("--fold", type=int, default=0,
                    help="use the BN-folded inference variant (selfplay path)")
    ap.add_argument("--batch-leaves", type=int, default=1,
                    help="multi-leaf rounds (search_batch_leaves)")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--keep", default=None, help="write the Chrome trace into this directory")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def run(args, print_fn=print):
    """The traced move; returns {"route", "launches" (the traced move's,
    by kernel), "unprofiled_ms", "profiled_ms", "table" (top_ops_table's
    summary)}."""
    from muzero_general_tpu_torch.config import load_game_module
    from muzero_general_tpu_torch.models import MuZeroNetwork, activation_dtype, fold_bn
    from muzero_general_tpu_torch.ops import mcts as mcts_ops

    device = resolve_device(args.device)
    print_fn(profiling.card_line(device))
    cfg = load_game_module(args.game).MuZeroConfig()
    cfg.num_simulations = args.sims
    cfg.search_batch_leaves = args.batch_leaves
    B = args.games
    A = len(cfg.action_space)
    net = MuZeroNetwork(cfg, device, seed=0)
    if args.fold:
        net = fold_bn(net, activation_dtype(cfg))
    obs = torch.zeros((B,) + profiling.stacked_shape(cfg), device=device)
    legal = torch.ones((B, A), dtype=torch.bool, device=device)
    to_play = torch.zeros((B,), dtype=torch.int32, device=device)
    spec = mcts_ops.SearchSpec.from_config(cfg, batch_size=B, device=device)
    if not args.pallas:
        spec = spec._replace(use_kernels=False, use_stream=False)
    route = ("kernel (planar)" if spec.use_kernels else
             "kernel (stream)" if spec.use_stream else "plain-op")

    def move():
        gen = torch.Generator(device=device).manual_seed(1)
        with torch.no_grad():
            return mcts_ops.run_mcts(net.initial_inference, net.recurrent_inference, obs,
                                     legal, to_play, gen, spec).root_visit_counts

    move()  # warm-up
    unprofiled = profiling.timeit(move, device) * 1e3
    before = profiling.launch_counts()
    rows, profiled, _ = profiling.device_trace(move, device, args.keep, f"trace_search_{args.game}")
    launches = profiling.launches_since(before)
    kept = f"{args.keep}/trace_search_{args.game}.json" if args.keep else "not kept (--keep DIR)"
    print_fn(f"# trace: {kept}")
    print_fn(f"# {args.game}: {B} lanes x {args.sims} sims, {args.batch_leaves} leaves a round, "
             f"{route} route, fold={bool(args.fold)}; the kernels' launches {launches}; "
             f"{profiled:.2f} ms profiled")
    table = profiling.top_ops_table(rows, args.top, per=args.sims, unit="simulation",
                                    unprofiled_ms=unprofiled, device=device,
                                    label=f" (pallas={bool(args.pallas)})", print_fn=print_fn)
    return {"route": route, "launches": launches, "unprofiled_ms": unprofiled,
            "profiled_ms": profiled, "table": table}


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
