"""Trace one fused train call of the learner on the card and print the top
device ops by total time (port of tools/trace_train.py).

`Learner.train_steps` (trainer.py) on `--fused` random batches of
`--batch` rows, the same recipe as the JAX tool (numpy default_rng(0):
normal observations, targets and actions, Dirichlet policies, unit weights,
gradient scale U), compute dtype bfloat16, weights from seed 0: one call to
warm up, one unprofiled (the wall time the busy share is taken against),
one under torch.profiler. The default game is atari, the shipped 16 x 256
downsampled ResNet (games/atari.py), whose config loads without ALE. The
losses of the first and the last call are printed, not checked: on these
random targets atari's SGD (lr 0.05, momentum 0.9) diverges within a few
steps, in the JAX package as here.

Usage (on the card; `--device cpu` checks the plumbing on the CPU):
    python -m muzero_general_tpu_torch.tools.trace_train [--game atari] \\
        [--batch 256] [--fused 2] [--top 30] [--keep DIR]

Prints the card's name and power limit, the peak device memory, then JAX's
table: total device op time, one row per kernel name (ms, launches, us per
launch, name), the launches per training step and the card's busy share of
the unprofiled call.
"""

import argparse
import sys

import numpy as np
import torch

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.tools import profiling


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--game", default="atari")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--fused", type=int, default=2)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--keep", default=None, help="write the Chrome trace into this directory")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def random_batches(cfg, M, seed=0):
    """The JAX tool's batches, stacked on a leading axis M."""
    B, U = cfg.batch_size, cfg.num_unroll_steps
    A = len(cfg.action_space)
    C, h, w = profiling.stacked_shape(cfg)
    rng = np.random.default_rng(seed)
    return {
        "observation": rng.normal(size=(M, B, C, h, w)).astype(np.float32),
        "action": rng.integers(0, A, (M, B, U + 1)).astype(np.int32),
        "target_value": rng.normal(size=(M, B, U + 1)).astype(np.float32),
        "target_reward": rng.normal(size=(M, B, U + 1)).astype(np.float32),
        "target_policy": rng.dirichlet(np.ones(A), (M, B, U + 1)).astype(np.float32),
        "weight": np.ones((M, B), np.float32),
        "gradient_scale": np.full((M, B, U + 1), U, np.float32),
    }


def run(args, print_fn=print):
    """The traced call; returns {"first_loss", "loss" (the fourth call's),
    "unprofiled_ms", "profiled_ms",
    "peak_gib" (None on the CPU), "table" (top_ops_table's summary)}."""
    from muzero_general_tpu_torch.config import load_game_module
    from muzero_general_tpu_torch.trainer import Learner

    device = resolve_device(args.device)
    print_fn(profiling.card_line(device))
    cfg = load_game_module(args.game).MuZeroConfig()
    cfg.compute_dtype = "bfloat16"
    cfg.batch_size = args.batch
    cfg.fused_train_steps = args.fused
    M = args.fused
    # The batches move to the card once, as the loop's prefetcher hands them.
    batches = {k: torch.from_numpy(v).to(device) for k, v in random_batches(cfg, M).items()}
    learner = Learner(cfg, device, seed=0)

    def call():
        metrics, _ = learner.train_steps(batches)
        return float(metrics["total_loss"])

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    first = call()  # warm-up
    unprofiled = profiling.timeit(call, device) * 1e3
    rows, profiled, _ = profiling.device_trace(call, device, args.keep, f"trace_train_{args.game}")
    loss = call()
    peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None
    kept = f"{args.keep}/trace_train_{args.game}.json" if args.keep else "not kept (--keep DIR)"
    print_fn(f"# trace: {kept}")
    print_fn(f"# {args.game}: {M} fused steps of batch {args.batch}, unroll "
             f"{cfg.num_unroll_steps}, bfloat16; loss {first:.4f} (first call), {loss:.4f} "
             f"(fourth); {profiled:.2f} ms profiled; "
             f"peak device memory "
             + (f"{peak:.3f} GiB" if peak is not None else "not measured (cpu)"))
    table = profiling.top_ops_table(rows, args.top, per=M, unit="step", unprofiled_ms=unprofiled,
                                    device=device, print_fn=print_fn)
    return {"first_loss": first, "loss": loss, "unprofiled_ms": unprofiled, "profiled_ms": profiled,
            "peak_gib": peak, "table": table}


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
