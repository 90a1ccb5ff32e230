"""Self-play traffic: the port's `SelfPlayDriver.play` on the configuration's
game, network and weights, at the lanes and search the traffic file sets.

Set-up builds the network, loads the weights file, builds the driver with
the run's seed and makes `warmup_calls` play() calls (the kernels build or
load and every shape of the window runs once). The window then calls
play() until `seconds` have passed; the rate is every env-step of those
calls over the time from the window's start to the end of the last one,
after a device synchronize.

Every MoveRecord that play_chunk returns is kept (the wrapper only keeps a
reference). After the window, with the peak memory read and the driver
freed, the reference judges them:
- every recorded move (warm-up and window) against the game's rules
  (reference/<game>.py `check_transitions`): observations, player to move,
  legality, rewards, done flags and the next observation;
- `check_moves` moves of the window drawn from the seed, every lane: the
  reference search (reference/search.py) from the recorded observation,
  with the driver's own noise and tie-jitter key replayed from the seed,
  against the recorded root visit counts, root value and the network's
  root value; and the recorded action against the Gumbel-max sample of the
  recorded visits with the replayed uniforms.

The traced run first profiles two play() calls (the card's operations
only; the first takes the profiler's start-up costs and is not measured)
with host spans around the layers' calls (`search`, `network`, `descend`,
`backprop`, `noise`, `select_action`, `env_step`, `move_loop`, `play`) and
the second call's tree-kernel leaf depths captured for their byte counts;
its window's calls then time play() and its play_chunk (which ends in a
synchronize) for the host's share and the idle share's divisor.
"""

import importlib

import numpy as np
import torch

from gpubench.drivers import (device_summary, now, peak_bytes, port_config, profiled, release,
                              sync)
from gpubench.reference import search as ref_search
from gpubench.reference.checkpoint import load_weights
from gpubench.reference.resnet import FullFloat32, ResNetReference
from gpubench.spans import Spans
from gpubench.yardstick import trace as trace_lib
from gpubench.yardstick import treework

FIELDS = ("observation", "action", "reward", "done", "to_play", "to_play_next",
          "child_visits", "root_value", "pred_value")


def _install_spans(spans, driver, work):
    """The traced call's spans, and the tree kernels' leaf depths."""
    from muzero_general_tpu_torch.models.resnet import ResMuZero
    from muzero_general_tpu_torch.ops import mcts as mcts_ops
    from muzero_general_tpu_torch.ops import mcts_kernels

    def descend_done(result, args, kwargs):
        work["descend_planar"].append((result[2], args[2], bool(kwargs.get("mark_visits"))))

    def backprop_seen(args, kwargs):
        work["backprop"].append((args[2], bool(kwargs.get("pre_marked"))))

    spans.wrap(mcts_ops, "run_mcts", "search")
    spans.wrap(mcts_ops, "add_root_noise", "noise")
    spans.wrap(mcts_ops, "select_action", "select_action")
    spans.wrap(mcts_kernels, "descend_planar", "descend", after=descend_done)
    spans.wrap(mcts_kernels, "backprop", "backprop", before=backprop_seen)
    spans.wrap(ResMuZero, "initial_inference", "network")
    spans.wrap(ResMuZero, "recurrent_inference", "network")
    spans.wrap(driver.env, "step", "env_step")


def _tree_work(work, lanes, num_actions, simulations):
    """(FLOPs, bytes) of every captured tree-kernel launch, by kernel."""
    D = simulations + 1
    out = {"descend_planar": [], "backprop": []}
    for leaf_depth, bound, marked in work["descend_planar"]:
        out["descend_planar"].append(treework.descend_work(
            leaf_depth, bound, lanes, num_actions, D, marked))
    for leaf_depth, pre_marked in work["backprop"]:
        out["backprop"].append(treework.backprop_work(leaf_depth, lanes, pre_marked))
    return out


def run(cell, seed, seconds, trace, device, t_start, control=None):
    from muzero_general_tpu_torch.checkpoint import load_checkpoint
    from muzero_general_tpu_torch.config import load_game_module
    from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    traffic, cfgd = cell.traffic, cell.config["config"]
    if cfgd["stacked_observations"]:
        raise NotImplementedError("the reference search takes unstacked observations only")
    cfg = port_config(cell, seed)
    net = MuZeroNetwork(cfg, device)
    net.load_state_dict(params_from_jax(load_checkpoint(cell.config["weights"])["weights"]))
    env = load_game_module(cell.config["game"]).make_env(device=device)
    driver = SelfPlayDriver(env, net, cfg, seed=seed, device=device)
    records, chunk_s = [], []
    inner = driver.play_chunk

    def keep_record(*args, **kwargs):
        t = now()
        out = inner(*args, **kwargs)
        if trace:
            sync(device)
            chunk_s.append(now() - t)
        records.append(out)
        return out

    driver.play_chunk = keep_record

    def play():
        return driver.play(traffic["temperature"], add_noise=traffic["add_noise"])

    for _ in range(traffic["warmup_calls"]):
        play()
    sync(device)
    setup_s = now() - t_start

    G, K, S = driver.G, cfg.selfplay_chunk_moves, cfg.num_simulations
    calls, prof, work = [], None, {"descend_planar": [], "backprop": []}
    if trace:  # the profiled call, then the window's calls for the spans
        spans = Spans()
        _install_spans(spans, driver, work)
        spans.wrap(driver, "play_chunk", "move_loop")
        try:
            prof, wall_s = profiled(play, device, spans, "play",
                                    between=lambda: [w.clear() for w in work.values()])
        finally:
            spans.restore()
        calls.append({"wall_s": wall_s, "moves": K, "profiled": True})
    t0 = now()
    while True:
        ts, n_chunks = now(), len(chunk_s)
        play()
        sync(device)
        te = now()
        calls.append({"wall_s": te - ts, "moves": K, "profiled": False,
                      "chunk_s": sum(chunk_s[n_chunks:]) if trace else None})
        if te - t0 >= seconds:
            break
    window_moves = K * sum(not c["profiled"] for c in calls)
    rate = G * window_moves / (te - t0)
    memory = peak_bytes(device)

    rec = {f: torch.cat([getattr(r, f) for r in records]).cpu().numpy() for f in FIELDS}
    first_window_move = (traffic["warmup_calls"] + 2 * int(trace)) * K  # past warm-up, profile
    tr = trace_lib.parse(prof, spans.intervals) if trace else None
    del prof
    readings = {"trace": tr, "calls": calls, "lanes": G, "simulations": S, "config": cfgd,
                "device_type": torch.device(device).type,
                "tree_work": _tree_work(work, G, len(cfgd["action_space"]), S)}
    del driver, net, env, records, inner, work
    release(device)

    win = slice(first_window_move, None)
    finite = np.isfinite(rec["root_value"][win]) & np.isfinite(rec["pred_value"][win])
    numbers = check(cell, seed, rec, first_window_move, device, control)
    extra, breakdown, note = device_summary(readings, "play")
    out = {"setup_s": setup_s, "end_to_end": {"selfplay_env_steps_per_s": rate},
           "readings": readings, "attempted": G * window_moves,
           "failed": int((~finite).sum()), "numbers": numbers, "memory_peak_bytes": memory,
           "device": extra, "breakdown": breakdown, "note": note}
    if control:
        out["numbers"], out["control_numbers"] = numbers
    return out


def reference_net(cell, device, precision="float32"):
    return ResNetReference(cell.config["config"], load_weights(cell.config["weights"], device),
                           precision)


def check(cell, seed, rec, first_window_move, device, control=None):
    """The compared numbers of the records `rec` ({field: [moves, G, ...]}).
    control: a lower precision ("tf32") whose reference is also compared
    with the float32 one, on the same moves; its numbers are returned
    beside the program's as (program, control)."""
    cfgd, traffic = cell.config["config"], cell.traffic
    game = importlib.import_module(f"gpubench.reference.{cell.config['game']}")
    spec = ref_search.SearchSpec.from_config(cfgd)
    moves, G, A = rec["child_visits"].shape
    bad = game.check_transitions(*(rec[f] for f in FIELDS[:6]))
    numbers = {"env_mismatches": int(bad.sum())}

    rng = np.random.default_rng(seed)
    window = np.arange(first_window_move, moves)
    sample = set(rng.choice(window, size=min(traffic["check_moves"], len(window)),
                            replace=False).tolist())
    stream = ref_search.DriverStream(seed, G, A, spec, device, traffic["add_noise"])
    net = reference_net(cell, device)
    ctl_net = reference_net(cell, device, control) if control else None
    temperature = torch.full((G,), float(traffic["temperature"]), device=device)
    gaps, prog, ref, ctl = [], [], [], []
    for m in range(max(sample) + 1):
        draws = stream.next_move()
        if m not in sample:
            continue
        obs = torch.from_numpy(rec["observation"][m]).to(device)
        legal = torch.from_numpy(game.legal_from_obs(rec["observation"][m])).to(device)
        visits = torch.from_numpy(np.rint(rec["child_visits"][m] * spec.num_simulations)
                                  .astype(np.int32)).to(device)
        scores, _ = ref_search.sampled_action_gap(visits, legal, temperature, draws.uniform)
        action = torch.from_numpy(rec["action"][m].astype(np.int64)).to(device)
        gaps.append((scores.amax(-1) - scores.gather(1, action[:, None])[:, 0]).cpu())
        prog.append((visits.cpu(), torch.from_numpy(rec["root_value"][m]),
                     torch.from_numpy(rec["pred_value"][m])))
        with torch.no_grad(), FullFloat32():
            ref.append(tuple(x.cpu() for x in ref_search.run(net, obs, legal, spec, draws)))
            if ctl_net is not None:
                ctl.append(tuple(x.cpu() for x in ref_search.run(ctl_net, obs, legal, spec, draws)))
    numbers["action_gap"] = float(torch.cat(gaps).max())
    numbers.update(search_numbers(prog, ref))
    if control:
        return numbers, search_numbers(ctl, ref)
    return numbers


def search_numbers(got, want):
    """Compare searches (visits [G, A], root value [G], predicted value [G])
    move by move: the widest gap of the network's root value, the share of
    searches whose root visit counts differ anywhere, and the mean gap of
    the searched root value (a search whose visits agree at the root may
    still differ deeper, so its widest gap swings with rare deep flips)."""
    v_got, r_got, p_got = (torch.cat(x) for x in zip(*got))
    v_want, r_want, p_want = (torch.cat(x) for x in zip(*want))
    differ = (v_got != v_want).any(-1)
    return {
        "value_gap": float((p_got - p_want).abs().max()),
        "visit_mismatch_share": float(differ.float().mean()),
        "root_value_gap_mean": float((r_got - r_want).abs().mean()),
    }
