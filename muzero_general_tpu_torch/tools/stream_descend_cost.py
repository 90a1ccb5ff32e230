"""Device time of the stream descent and the edge update on gomoku's
mid-search slab.

Builds the slab that chip_smoke.py's phase 8a builds (gomoku, 64 lanes ten
random plies into a game, the 6 x 128 ResNet with seeded random weights, 200
of 400 simulations on the stream route) with the port found under --root,
holds `descend_stream` against `descend_stream_plain` (all eight outputs
equal) and `update_edges` on that descent's paths (phase 8a's: every 8th
lane cut to a depth-1 leaf under the deepest lane's bound) against
`update_edges_plain` (every live slab row equal), and times each as the
median of --graphs CUDA graphs of 50 launches; the update also with bound
0, the same launch with nothing to update (its floor). Prints the card's
name and power limit, then one JSON line: ms per launch, us per level of
the deepest lane (descent), the update's ms and floor_ms.

    python3 muzero_general_tpu_torch/tools/stream_descend_cost.py [--root DIR] [--graphs 9]

Run it by its path, not with -m: the port is imported from --root (by
default the checkout that holds this file) only after the argument is read.

To compare two checkouts, run it once per checkout in one chip call, in the
order parent, change, change, parent. Every checkout whose stream kernels
are bit-equal to their plain versions builds the same slab.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]),
                    help="checkout whose muzero_general_tpu_torch is timed")
    ap.add_argument("--graphs", type=int, default=9)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("stream_descend_cost: no CUDA device")
    from muzero_general_tpu_torch.games.gomoku import MuZeroConfig, make_env
    from muzero_general_tpu_torch.models import MuZeroNetwork, fold_bn
    from muzero_general_tpu_torch.ops import mcts as mcts_ops
    from muzero_general_tpu_torch.ops import mcts_stream

    if not pathlib.Path(mcts_stream.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"stream_descend_cost: imported {mcts_stream.__file__}, not from {root}")

    dev = torch.device("cuda")
    cfg = MuZeroConfig()
    cfg.parallel_games = 64
    B, A = cfg.parallel_games, len(cfg.action_space)
    folded = fold_bn(MuZeroNetwork(cfg, seed=0))
    env = make_env()
    gen = torch.Generator(device=dev).manual_seed(41)
    spec = mcts_ops.SearchSpec.from_config(cfg, B, dev)
    if not spec.use_stream:
        raise SystemExit("stream_descend_cost: gomoku at 64 lanes did not take the stream route")
    state = env.reset(B, gen)
    for _ in range(10):
        state, _, _ = env.step(state, env.random_legal_action(state, gen), gen)
    obs, legal, to_play = env.observation(state), env.legal_actions_mask(state), env.to_play(state)
    sim, seed = cfg.num_simulations // 2, 4242
    with torch.no_grad():
        out = mcts_ops.run_mcts(folded.initial_inference, folded.recurrent_inference, obs,
                                legal, to_play, gen, spec, seed=seed, num_steps=sim)
    D = cfg.num_simulations + 1
    edges = mcts_stream.pack_tree(out.tree, A)
    depth_bound = (out.max_tree_depth.max() + 1).to(torch.int32)
    dargs = (seed, sim, depth_bound, edges, legal.to(torch.int32).contiguous(),
             out.tree.min_value, out.tree.max_value)
    dkw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
               pb_c_init=spec.pb_c_init, discount=spec.discount, A=A,
               max_depth=spec.max_depth, tie_jitter=spec.tie_jitter)
    got = mcts_stream.descend_stream(*dargs, **dkw)
    want = mcts_stream.descend_stream_plain(*dargs, **dkw)
    for g, w in zip([*got[:5], *got[5]], [*want[:5], *want[5]]):
        if not torch.equal(g, w):
            raise SystemExit("stream_descend_cost: descend_stream differs from its plain version")
    deepest = int(got[2].max())

    # The update on this descent's paths, as chip_smoke.py's phase 8a hands
    # them over: every 8th lane cut to a depth-1 leaf, the bound the deepest
    # lane's, masked levels aimed at the dummy row.
    upd_depth = got[2].clone()
    upd_depth[::8] = 1
    live = torch.arange(D, device=dev)[:, None] < upd_depth[None, :].long()
    delta = torch.randn((D, B), generator=gen, device=dev) * live
    pn = torch.where(live, got[3], edges.shape[1] - 1)
    pa = torch.where(live, got[4], 0)
    mask = live.to(torch.float32)
    bound = torch.amax(upd_depth)
    k_edges = mcts_stream.update_edges(edges.clone(), pn, pa, delta, mask, bound)
    p_edges = mcts_stream.update_edges_plain(edges.clone(), pn, pa, delta, mask, bound)
    torch.cuda.synchronize()
    if not torch.equal(k_edges[:, :-1].view(torch.int32), p_edges[:, :-1].view(torch.int32)):
        raise SystemExit("stream_descend_cost: update_edges differs from its plain version")

    def timed(fn):
        samples = []
        with torch.no_grad():
            for _ in range(args.graphs):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(50):
                        fn()
                graph.replay()  # warm
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                torch.cuda.synchronize()
                samples.append(start.elapsed_time(end) / 50)
        return statistics.median(samples), samples

    ms, samples = timed(lambda: mcts_stream.descend_stream(*dargs, **dkw))
    w_edges = edges.clone()
    none = torch.zeros_like(bound)
    u_ms, u_samples = timed(lambda: mcts_stream.update_edges(w_edges, pn, pa, delta, mask, bound))
    f_ms, f_samples = timed(lambda: mcts_stream.update_edges(w_edges, pn, pa, delta, mask, none))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"root": str(root), "ms": ms, "per_level_us": 1e3 * ms / deepest,
                      "deepest": deepest, "samples_ms": samples,
                      "update_edges": {"ms": u_ms, "floor_ms": f_ms, "bound": int(bound),
                                       "samples_ms": u_samples, "floor_samples_ms": f_samples}}))


if __name__ == "__main__":
    main()
