"""Device time of the planar descent and the backprop (both modes) and the
fused search.

Builds the inputs chip_smoke.py's phases 4a, 4e and 3b build, with the port
found under --root: connect4's 256-lane tree after 100 of 200 simulations
(the pretrained 3 x 64 ResNet, K = 1), the same at 8 leaves per round after
96 simulations, and cartpole's 4,096 roots after one 8-move chunk of
self-play (the pretrained FC net, 50 simulations, tie jitter on), and the
same search on phase 3a's 64-wide net (seeded weights) at 4,096 random
roots. Holds `descend_planar` (both modes) against `descend_planar_plain`
(all outputs and the marked slab equal), `backprop` on the next descent's
paths (K = 1) and pre-marked on the round's 8 marking paths folded one
after another (K = 8) against `backprop_plain` (all six outputs equal),
and `search` against `search_plain` (visits and depth equal, root values
within 1e-5), then times each kernel: the descent and the backprop as the
median of --graphs CUDA graphs of 50 launches (the backprop on the first
path; again with every leaf depth -1, the same launch with nothing to back
up: its floor; and with the leaf depths capped at 0, 1, 2, 4 and 8, its
cost by depth), the fused search as the median of --graphs runs of 5
launches between CUDA events. Prints the card's name and power limit, then
one JSON line: ms per launch, us per level of the deepest lane (descent,
backprop), floor_ms and depth_<c>_ms (backprop), us per simulation (fused
search).

    python3 muzero_general_tpu_torch/tools/tree_kernel_cost.py [--root DIR] [--graphs 5]

Run it by its path, not with -m: the port is imported from --root (by
default the checkout that holds this file) only after the argument is read.

To compare two checkouts, run it once per checkout in one chip call, in the
order parent, change, change, parent. Every checkout whose kernels are
bit-equal to their plain versions builds the same inputs.
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
    ap.add_argument("--graphs", type=int, default=5)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tree_kernel_cost: no CUDA device")
    from muzero_general_tpu_torch.checkpoint import load_checkpoint
    from muzero_general_tpu_torch.config import MuZeroConfig as BaseConfig
    from muzero_general_tpu_torch.games import cartpole, connect4
    from muzero_general_tpu_torch.models import MuZeroNetwork, fold_bn, params_from_jax
    from muzero_general_tpu_torch.ops import mcts as mcts_ops
    from muzero_general_tpu_torch.ops import mcts_fused, mcts_kernels
    from muzero_general_tpu_torch.ops.stacking import stack_observations
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    if not pathlib.Path(mcts_kernels.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"tree_kernel_cost: imported {mcts_kernels.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def pretrained(cfg, game):
        net = MuZeroNetwork(cfg)
        path = root / "pretrained" / game / "model.checkpoint"
        net.load_state_dict(params_from_jax(load_checkpoint(path)["weights"]))
        return net

    def events_ms(fn, reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, reps=50):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()  # warm
        return events_ms(graph.replay, 1) / reps

    result = {"root": str(root)}

    # ---- the planar descent: phase 4a's tree (K = 1), 4e's (K = 8) --------
    for K, sim, seed, gen_seed in ((1, 100, 12345, 11), (8, 96, 5151, 51)):
        cfg = connect4.MuZeroConfig()
        cfg.parallel_games = 256
        cfg.search_batch_leaves = K
        folded = fold_bn(pretrained(cfg, "connect4"))
        env = connect4.make_env()
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        B = cfg.parallel_games
        spec = mcts_ops.SearchSpec.from_config(cfg, B, dev)
        if not spec.use_kernels:
            raise SystemExit("tree_kernel_cost: connect4 did not take the kernel route")
        state = env.reset(B, gen)
        for _ in range(6):
            state, _, _ = env.step(state, env.random_legal_action(state, gen), gen)
        obs, legal, to_play = (env.observation(state), env.legal_actions_mask(state),
                               env.to_play(state))
        with torch.no_grad():
            out = mcts_ops.run_mcts(folded.initial_inference, folded.recurrent_inference, obs,
                                    legal, to_play, gen, spec, seed=seed, num_steps=sim)
        values = torch.randn((K, B), generator=gen, device=dev) * 3  # chip_smoke's leaf values
        tree = mcts_ops._to_planar(out.tree)
        depth_bound = (out.max_tree_depth.max() + 1).to(torch.int32)
        mark = K > 1
        kw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
                  pb_c_init=spec.pb_c_init, discount=spec.discount,
                  max_depth=spec.max_depth, tie_jitter=spec.tie_jitter, mark_visits=mark)

        legal_i32 = legal.to(torch.int32).contiguous()  # outside the graphs: no cast in them

        def dargs(visit, k=0):
            return (seed, sim + k, depth_bound, tree.children_index, tree.children_prior, visit,
                    tree.children_vsum, tree.children_reward, legal_i32, tree.min_value,
                    tree.max_value)

        k_visit, p_visit = tree.children_visit.clone(), tree.children_visit.clone()
        got = mcts_kernels.descend_planar(*dargs(k_visit), **kw)
        want = mcts_kernels.descend_planar_plain(*dargs(p_visit), **kw)
        torch.cuda.synchronize()
        for g, w in zip((*got, k_visit), (*want, p_visit)):
            if not torch.equal(g, w):
                raise SystemExit(f"tree_kernel_cost: descend_planar (K = {K}) differs from "
                                 "its plain version")
        deepest = int(got[2].max())
        w_visit = tree.children_visit.clone()  # the marking mode's marks pile up here
        samples = [graph_ms(lambda: mcts_kernels.descend_planar(*dargs(w_visit), **kw))
                   for _ in range(args.graphs)]
        ms = statistics.median(samples)
        name = "descend_planar_mark" if mark else "descend_planar"
        result[name] = {"ms": ms, "per_level_us": 1e3 * ms / deepest, "deepest": deepest,
                        "samples_ms": samples}

        # The backprop on this tree's next descent (K = 1), or pre-marked on
        # the round's K marking paths, folded one after another (K = 8).
        s_visit = tree.children_visit.clone()
        sels = [mcts_kernels.descend_planar(*dargs(s_visit, k), **kw) for k in range(K)]
        marked = tree._replace(children_visit=s_visit, root_visit=tree.root_visit + K * mark)
        bkw = dict(num_players=spec.num_players, discount=spec.discount, planar=True,
                   pre_marked=mark)

        def bargs(t, k, depth=None):
            s = sels[k]
            return (s[3], s[4], s[2] if depth is None else depth, values[k], t.children_visit,
                    t.children_vsum, t.children_reward, t.root_visit, t.root_vsum,
                    t.root_reward, t.min_value, t.max_value)

        outs = []
        for fn in (mcts_kernels.backprop, mcts_kernels.backprop_plain):
            t = mcts_ops.Tree(*(x.clone() for x in marked))
            for k in range(K):
                out = fn(*bargs(t, k), **bkw)
            outs.append(out)
        torch.cuda.synchronize()
        for g, w in zip(*outs):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise SystemExit(f"tree_kernel_cost: backprop (K = {K}) differs from its plain "
                                 "version")
        w_tree = mcts_ops.Tree(*(x.clone() for x in marked))  # the same path, folded again
        depth = sels[0][2]
        timed = {}
        for key, d in (("ms", depth), ("floor_ms", torch.full_like(depth, -1)),
                       *((f"depth_{c}_ms", depth.clamp(max=c)) for c in (0, 1, 2, 4, 8))):
            samples = [graph_ms(lambda: mcts_kernels.backprop(*bargs(w_tree, 0, d), **bkw))
                       for _ in range(args.graphs)]
            timed[key] = statistics.median(samples)
            timed[key.replace("ms", "samples_ms")] = samples
        deepest = int(depth.max())
        name = "backprop_pre_marked" if mark else "backprop"
        result[name] = timed | {"per_level_us": 1e3 * timed["ms"] / deepest, "deepest": deepest}

    # ---- the fused search: phase 3b's 4,096 roots ----------------------------
    cfg = cartpole.MuZeroConfig()
    cfg.num_simulations = 50
    cfg.parallel_games = 4096
    cfg.selfplay_chunk_moves = 8
    net = pretrained(cfg, "cartpole")
    driver = SelfPlayDriver(cartpole.make_env(), net, cfg, seed=0)
    driver.play(temperature=1.0)
    carry = driver._carry
    with torch.no_grad():
        stacked = stack_observations(carry.obs_hist, carry.act_hist, driver.A)
        legal = driver.env.legal_actions_mask(carry.env_state)
        to_play = driver.env.to_play(carry.env_state)
        roots = mcts_fused.prepare_root(net, stacked, legal, to_play, driver.generator,
                                        driver.fused_spec)
        weights = mcts_fused.fused_weights(net, cfg.encoding_size)
        fargs = (roots.prior, roots.hidden, roots.reward, roots.to_play, roots.legal, weights)
        fkw = mcts_fused.search_kwargs(driver.fused_spec) | {"seed": 1}
        got = mcts_fused.search(*fargs, **fkw)
        want = mcts_fused.search_plain(*fargs, **fkw)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
                and float((got[1] - want[1]).abs().max()) <= 1e-5):
            raise SystemExit("tree_kernel_cost: the fused search differs from search_plain")
        samples = [events_ms(lambda: mcts_fused.search(*fargs, **fkw), 5)
                   for _ in range(args.graphs)]
    ms = statistics.median(samples)
    result["fused_search"] = {"ms": ms, "per_sim_us": 1e3 * ms / cfg.num_simulations,
                              "samples_ms": samples}

    # ---- the fused search at phase 3a's 64-wide net, 4,096 lanes ----------
    wide = BaseConfig()
    wide.observation_shape = (1, 1, 8)
    wide.action_space = list(range(4))
    wide.encoding_size = 10
    wide.fc_dynamics_layers = wide.fc_reward_layers = [64]
    wide.fc_value_layers = wide.fc_policy_layers = [64]
    wide_net = MuZeroNetwork(wide, seed=1).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    B = 4096
    obs = torch.randn((B, 1, 1, 8), generator=gen, device=dev) * 0.5
    legal = torch.rand((B, 4), generator=gen, device=dev) < 0.7
    legal[:, 0] = True
    to_play = torch.zeros((B,), dtype=torch.int32, device=dev)
    spec = mcts_fused.FusedSpec.from_config(wide)
    with torch.no_grad():
        roots = mcts_fused.prepare_root(wide_net, obs, legal, to_play, gen, spec)
        weights = mcts_fused.fused_weights(wide_net, wide.encoding_size)
        fargs = (roots.prior, roots.hidden, roots.reward, roots.to_play, roots.legal, weights)
        fkw = mcts_fused.search_kwargs(spec) | {"seed": 3}
        got = mcts_fused.search(*fargs, **fkw)
        want = mcts_fused.search_plain(*fargs, **fkw)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
                and float((got[1] - want[1]).abs().max()) <= 1e-5):
            raise SystemExit("tree_kernel_cost: the 64-wide fused search differs from "
                             "search_plain")
        samples = [events_ms(lambda: mcts_fused.search(*fargs, **fkw), 5)
                   for _ in range(args.graphs)]
    ms = statistics.median(samples)
    result["fused_search_64wide"] = {"ms": ms, "per_sim_us": 1e3 * ms / wide.num_simulations,
                                     "samples_ms": samples}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
