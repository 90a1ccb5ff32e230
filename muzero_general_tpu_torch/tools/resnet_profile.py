"""Per-component timing of the board-game (ResNet) self-play path on the card
(port of tools/resnet_profile.py).

Decomposes one connect4 self-play move (`--games` lanes x `--sims`
simulations, the 3 x 64 ResNet with seeded weights, seed 0, at `--dtype`):

  net_scan     -- `--sims` sequential recurrent inferences alone
  hidden_rw    -- `--sims` gathers of row `parent` and writes of row i + 1 on
                  the hidden store, lane-major [B, N, ...] and node-major
                  [N, B, ...] (the search's layout), in place
  search_stub  -- the whole search with the network replaced by constants
                  (the tree work alone), on the route SearchSpec.from_config
                  picks
  mcts_pallas  -- the whole search on the kernel route: the planar descent and
                  backprop kernels (csrc/mcts_kernels.cu); on the TPU this was
                  the Pallas route, hence the key
  mcts_xla     -- the whole search on the plain-op route (the descent and
                  backprop in PyTorch ops); on the TPU, XLA's
  kernels      -- `descend_kernel_us`: one launch of the node-major descent
                  (ops/mcts_kernels.descend, kernel 6) on the end-state tree
                  of a plain-op search, checked once against descend_plain
                  (all five outputs equal), then timed as the mean of 10
                  calls like the other components (host issue included, as
                  the JAX tool's host pulls included dispatch)
  chunk        -- the production driver's chunk (4 moves): env-steps/s, and
                  whether its search took the kernel route (`chunk_pallas`)

Each component is the mean of 3 calls after one warm-up, on the host clock
after a device synchronize, as the JAX tool timed with a host pull.

Usage (on the card; `--device cpu` checks the plumbing on the CPU):
    python -m muzero_general_tpu_torch.tools.resnet_profile [--games 256] \\
        [--sims 200] [--dtype bfloat16] [--skip chunk,...]

Prints the card's name and power limit, one `#` line a component on
stderr, then the JAX tool's JSON line of results, with the kernels'
launches under "launches".
"""

import argparse
import json
import sys
import time

import torch

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.tools import profiling

REPS = 3  # timed calls of each component, after one warm-up
COMPONENTS = ("net_scan", "hidden_rw", "search_stub", "mcts_pallas", "mcts_xla", "kernels",
              "chunk")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--games", type=int, default=256)
    ap.add_argument("--sims", type=int, default=200)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--skip", default="", help="comma list of " + ", ".join(COMPONENTS))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def run(args, log=lambda msg: print(msg, file=sys.stderr)):
    """The components; returns the JAX tool's results dict plus
    "launches" (the kernels', by kernel, over the whole run) and
    "descend_kernel_checked" (the launch equal to descend_plain)."""
    from muzero_general_tpu_torch.games.connect4 import MuZeroConfig, make_env
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.ops import mcts as mcts_ops
    from muzero_general_tpu_torch.ops import mcts_kernels
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    skip = set(args.skip.split(",")) if args.skip else set()
    device = resolve_device(args.device)
    print(profiling.card_line(device))
    before = profiling.launch_counts()
    cfg = MuZeroConfig()
    cfg.parallel_games = args.games
    cfg.num_simulations = args.sims
    cfg.selfplay_chunk_moves = 4
    cfg.compute_dtype = args.dtype

    B = args.games
    A = len(cfg.action_space)
    net = MuZeroNetwork(cfg, device, seed=0)
    obs = torch.zeros((B,) + profiling.stacked_shape(cfg), device=device)
    legal = torch.ones((B, A), dtype=torch.bool, device=device)
    to_play = torch.zeros((B,), dtype=torch.int32, device=device)

    def generator():
        return torch.Generator(device=device).manual_seed(1)

    torch.set_grad_enabled(False)
    try:
        hidden0 = net.initial_inference(obs)[3]
        results = {"B": B, "sims": args.sims, "dtype": args.dtype,
                   "hidden_dtype": str(hidden0.dtype).replace("torch.", "")}
        log(f"# hidden {tuple(hidden0.shape)} {hidden0.dtype}")

        # ---- 1. network-only sequential scan ---------------------------
        if "net_scan" not in skip:
            def net_scan():
                h, vs = hidden0, []
                for i in range(args.sims):
                    v, _, _, h = net.recurrent_inference(
                        h, torch.full((B,), i % A, dtype=torch.long, device=device))
                    vs.append(v[:, 0])
                return torch.stack(vs).sum()

            dt = profiling.timeit(net_scan, device, REPS, warmup=1)
            results["net_scan_ms"] = round(dt * 1e3, 2)
            results["net_call_us"] = round(dt / args.sims * 1e6, 1)
            log(f"# net_scan: {dt * 1e3:.1f} ms ({dt / args.sims * 1e6:.0f} us/call)")

        # ---- 2. hidden-store gather + write, both layouts --------------
        if "hidden_rw" not in skip:
            N = args.sims + 1
            b_idx = torch.arange(B, device=device)
            parent = torch.zeros((B,), dtype=torch.long, device=device)

            def hidden_rw_lane_major():
                store = torch.zeros((B, N) + hidden0.shape[1:], dtype=hidden0.dtype,
                                    device=device)
                store[:, 0] = hidden0
                outs = []
                for i in range(args.sims):
                    h = store[b_idx, parent]
                    store[:, i + 1] = h * 1.000001
                    outs.append(h[:, 0, 0, 0])
                return torch.stack(outs).sum()

            def hidden_rw_node_major():
                store = torch.zeros((N, B) + hidden0.shape[1:], dtype=hidden0.dtype,
                                    device=device)
                store[0] = hidden0
                outs = []
                for i in range(args.sims):
                    h = store[parent, b_idx]
                    store[i + 1] = h * 1.000001
                    outs.append(h[:, 0, 0, 0])
                return torch.stack(outs).sum()

            for tag, fn in (("hidden_rw_lane_major", hidden_rw_lane_major),
                            ("hidden_rw_node_major", hidden_rw_node_major)):
                dt = profiling.timeit(fn, device, REPS, warmup=1)
                results[f"{tag}_ms"] = round(dt * 1e3, 2)
                log(f"# {tag}: {dt * 1e3:.1f} ms")

        # ---- 3. search with a constant-network stub --------------------
        if "search_stub" not in skip:
            S2 = 2 * cfg.support_size + 1
            k0 = torch.Generator(device=device).manual_seed(7)
            stub_v = torch.randn((B, S2), generator=k0, device=device)
            stub_p = torch.randn((B, A), generator=k0, device=device)

            def stub_recurrent(h, a):
                # Depends on (h, a) weakly, as the JAX tool's stub.
                bump = h.reshape(h.shape[0], -1)[:, :1].float() * 1e-6 + a[:, None] * 1e-6
                return stub_v + bump, stub_v - bump, stub_p + bump, h * 0.999

            sp = mcts_ops.SearchSpec.from_config(cfg, batch_size=B, device=device)

            def run_stub():
                return mcts_ops.run_mcts(net.initial_inference, stub_recurrent, obs, legal,
                                         to_play, generator(), sp).root_visit_counts

            dt = profiling.timeit(run_stub, device, REPS, warmup=1)
            results["search_stub_ms"] = round(dt * 1e3, 2)
            log(f"# search_stub (kernels={sp.use_kernels}): {dt * 1e3:.1f} ms")

        # ---- 4. the whole search, kernel route and plain-op route ------
        for tag, use_kernels in (("mcts_pallas", True), ("mcts_xla", False)):
            if tag in skip:
                continue
            sp = mcts_ops.SearchSpec.from_config(cfg, batch_size=B, device=device)
            sp = sp._replace(use_kernels=use_kernels and sp.use_kernels, use_stream=False)

            def run_full(sp=sp):
                return mcts_ops.run_mcts(net.initial_inference, net.recurrent_inference, obs,
                                         legal, to_play, generator(), sp).root_visit_counts

            dt = profiling.timeit(run_full, device, REPS, warmup=1)
            results[f"{tag}_ms"] = round(dt * 1e3, 2)
            results[f"{tag}_env_steps_per_s"] = round(B / dt, 1)
            log(f"# {tag} (kernels={sp.use_kernels}): {dt * 1e3:.1f} ms/move -> "
                f"{B / dt:.0f} env-steps/s")

        # ---- 4b. kernel 6 on a realistic (end-state) tree --------------
        if "kernels" not in skip:
            sp = mcts_ops.SearchSpec.from_config(cfg, batch_size=B, device=device)._replace(
                use_kernels=False, use_stream=False)
            out = mcts_ops.run_mcts(net.initial_inference, net.recurrent_inference, obs, legal,
                                    to_play, generator(), sp)
            tree = out.tree  # node-major [B, N, A], as the plain-op route keeps it
            depth_bound = (out.max_tree_depth.max() + 1).to(torch.int32)
            legal_i32 = legal.to(torch.int32)
            kw = dict(num_players=sp.num_players, pb_c_base=sp.pb_c_base,
                      pb_c_init=sp.pb_c_init, discount=sp.discount, max_depth=args.sims,
                      tie_jitter=sp.tie_jitter)
            desc_args = (7, 64, depth_bound) + tuple(
                t.contiguous() for t in (tree.children_index, tree.children_prior,
                                         tree.children_visit, tree.children_vsum,
                                         tree.children_reward, legal_i32, tree.min_value,
                                         tree.max_value))
            got = mcts_kernels.descend(*desc_args, **kw)
            want = mcts_kernels.descend_plain(*desc_args, **kw)
            for name, g, w in zip(("parent", "action", "leaf_depth", "path_nodes",
                                   "path_actions"), got, want):
                if not torch.equal(g, w):
                    raise SystemExit(f"resnet_profile: the node-major descent's {name} "
                                     "differs from descend_plain")
            results["descend_kernel_checked"] = True

            def desc():
                return mcts_kernels.descend(*desc_args, **kw)[0]

            dt = profiling.timeit(desc, device, 10, warmup=1)
            results["descend_kernel_us"] = round(dt * 1e6, 1)
            log(f"# descend kernel (end-state tree, equal to descend_plain): "
                f"{dt * 1e3:.3f} ms")

        # ---- 5. production driver chunk --------------------------------
        if "chunk" not in skip:
            driver = SelfPlayDriver(make_env(device=device), net, cfg, seed=0, device=device)
            driver.play(1.0)  # warm-up
            profiling.synchronize(device)
            t0 = time.time()
            reps = 2
            for _ in range(reps):
                _, stats = driver.play(1.0)
            profiling.synchronize(device)
            dt = (time.time() - t0) / reps
            results["chunk_env_steps_per_s"] = round(stats["env_steps"] / dt, 1)
            results["chunk_pallas"] = bool(driver.spec.use_kernels)
            log(f"# chunk: {stats['env_steps'] / dt:.0f} env-steps/s "
                f"(kernels={driver.spec.use_kernels})")
    finally:
        torch.set_grad_enabled(True)
    results["launches"] = profiling.launches_since(before)
    return results


def main(argv=None):
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
