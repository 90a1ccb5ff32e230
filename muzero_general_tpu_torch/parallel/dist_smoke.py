"""Multi-process smoke: global-mesh training and per-rank self-play (port of
parallel/dist_smoke.py).

Runs the wiring MuZero uses multi-host (parallel/distributed.py): one
process per rank over torch.distributed, one global dp mesh spanning them,
a sharded train step fed by per-rank local batches, per-rank self-play on
each rank's own device, and a global counter sum. Launched once per rank
(tests/test_torch_distributed.py starts two on the CPU).

Usage (each process):
  python -m muzero_general_tpu_torch.parallel.dist_smoke \\
      --coordinator 127.0.0.1:PORT --num-processes 2 --process-id I \\
      [--device cpu] [--backend gloo]
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--device", default=None, help='"cpu", or a card (default: the rank\'s)')
    ap.add_argument("--backend", default=None, help="default: gloo or nccl, by the devices")
    args = ap.parse_args(argv)

    from muzero_general_tpu_torch.parallel import distributed as dist

    dist.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        backend=args.backend,
        device=args.device,
    )

    import numpy as np
    import torch

    assert dist.process_count() == args.num_processes, dist.process_count()
    device = dist.device()
    n_global = dist.process_count()

    from muzero_general_tpu_torch.config import MuZeroConfig
    from muzero_general_tpu_torch.parallel import create_mesh, make_sharded_train_step
    from muzero_general_tpu_torch.trainer import Learner

    # ---- phase 1: two train steps on the GLOBAL mesh ----------------------
    cfg = MuZeroConfig()
    cfg.observation_shape = (1, 1, 4)
    cfg.action_space = list(range(2))
    cfg.num_unroll_steps = 3
    cfg.batch_size = 2 * n_global  # 2 rows per rank, globally
    mesh = create_mesh(num_dp=n_global, num_mp=1)

    learner = Learner(cfg, device, seed=0)
    step_fn = make_sharded_train_step(learner, mesh)

    B_local = cfg.batch_size // args.num_processes
    U, A = cfg.num_unroll_steps, 2
    rng = np.random.default_rng(100 + args.process_id)
    local = {
        "observation": rng.normal(size=(B_local, 1, 1, 4)).astype(np.float32),
        "action": rng.integers(0, A, (B_local, U + 1)).astype(np.int32),
        "target_value": rng.normal(size=(B_local, U + 1)).astype(np.float32),
        "target_reward": rng.normal(size=(B_local, U + 1)).astype(np.float32),
        "target_policy": rng.dirichlet(np.ones(A), (B_local, U + 1)).astype(
            np.float32
        ),
        "weight": np.ones(B_local, np.float32),
        "gradient_scale": np.full((B_local, U + 1), U, np.float32),
    }
    step_fn(dist.process_local_batch(local, mesh))
    metrics, _ = step_fn(dist.process_local_batch(local, mesh))
    # The loss metrics are the all_reduced sums: every rank must hold the
    # identical value (the gradient all_reduce worked).
    losses = [None] * n_global
    torch.distributed.all_gather_object(losses, float(metrics["total_loss"]))
    losses = np.asarray(losses)
    assert np.isfinite(losses).all(), losses
    assert (losses == losses[0]).all(), losses

    # ---- phase 2: per-rank self-play on the rank's own device ---------------
    # (the reference's "SelfPlay actors on every node", muzero.py:177-196)
    from muzero_general_tpu_torch.envs.cartpole import CartPole
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    sp = MuZeroConfig()
    sp.num_simulations = 4
    sp.parallel_games = 4
    sp.selfplay_chunk_moves = 4
    sp.max_moves = 12
    network = MuZeroNetwork(sp, device, seed=1)
    driver = SelfPlayDriver(CartPole(device=device), network, sp, seed=args.process_id,
                            device=device)
    _, stats = driver.play(temperature=1.0)
    assert stats["env_steps"] == sp.parallel_games * sp.selfplay_chunk_moves

    # ---- phase 3: global counter sum (exact-ratio bookkeeping) -------------
    total = dist.global_sum(stats["env_steps"])
    assert total == args.num_processes * stats["env_steps"], total

    print(
        f"dist_smoke OK: process {args.process_id}/{args.num_processes}, "
        f"{n_global} ranks on {device} ({torch.distributed.get_backend()}), "
        f"loss={losses[0]:.6f}, global env_steps={total:.0f}",
        flush=True,
    )
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
