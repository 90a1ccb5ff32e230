#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (muzero_general_tpu_torch) on one GPU.

    python3 chip_smoke.py

In order, it:
1. prints the card's name and power limit;
2. builds the fused-search kernel (csrc/mcts_fused.cu) from the checkout with
   nvcc and prints the build time and ptxas' register/shared-memory report;
3. holds the kernel against its plain PyTorch version (search_plain) on the
   card, tie jitter 0, in three cases: cartpole with the pretrained weights
   and Dirichlet noise, a 2-player search with the same net, and a 64-wide
   lunarlander-shaped net (A=4, E=10) with random weights. Visit counts and
   depth must be equal, root values within 1e-5;
4. runs the main path: SelfPlayDriver on cartpole at 4,096 lanes x 50
   simulations, chunks of 8 moves, pretrained weights, tie jitter 1e-5; times
   3 chunks and checks that the kernel was launched once per move played.
   Then, at the 4,096 mid-episode roots it reached and with the same tie
   jitter (the same Philox stream on both sides), it holds the kernel against
   search_plain as in 3 and times both;
5. plays 64 greedy lanes (temperature 0, no noise) for 500 moves and fails
   if the mean return of the completed episodes is below 100;
6. prints one {"kernels": [...]} JSON line, then ends with
   {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when no CUDA card is present or any
phase fails. It imports nothing of JAX.
"""

import json
import pathlib
import subprocess
import sys
import time

import torch

REPO = pathlib.Path(__file__).resolve().parent
CHECKPOINT = REPO / "pretrained" / "cartpole" / "model.checkpoint"
SOURCE = "muzero_general_tpu_torch/csrc/mcts_fused.cu"
REPLACES = "muzero_general_tpu/ops/mcts_fused.py:235"
# One H100 SXM at its 700 W limit (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
VALUE_TOL = 1e-5


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, by CUDA events (the caller
    has made one call before, which warms up)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def search_work(B, A, E, num_sims, weights):
    """(FLOPs, bytes) of one search: the MLP arithmetic the simulations need
    (descent and backprop arithmetic left out: data-dependent and smaller),
    and each input read and each output written once."""
    flops_per_sim = 0
    for layer, (fan_in, fan_out) in enumerate(weights.dims):
        if layer == 0:  # the one-hot part of the first layer is one row add
            flops_per_sim += 2 * E * fan_out + 2 * fan_out
        else:
            flops_per_sim += 2 * fan_in * fan_out + fan_out
    flops = flops_per_sim * num_sims * B
    nbytes = 4 * (B * A + B * E + B + B + B * A + weights.flat.numel()
                  + B * A + B + B)
    return flops, nbytes


def bound_ms(flops, nbytes):
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def load_pretrained(net):
    from muzero_general_tpu_torch.checkpoint import load_checkpoint
    from muzero_general_tpu_torch.models import params_from_jax

    net.load_state_dict(params_from_jax(load_checkpoint(CHECKPOINT)["weights"]))
    return net


def check_equal(name, got, want, legal, num_sims):
    """Fail unless the kernel's (visits, value, depth) equal search_plain's:
    visits and depth exactly, values within VALUE_TOL; every root's visits
    sum to num_sims and illegal actions get none. Returns max |dvalue|."""
    torch.cuda.synchronize()
    visits, value, depth = (t.cpu() for t in got)
    p_visits, p_value, p_depth = (t.cpu() for t in want)
    bad_v = (visits != p_visits).any(1)
    bad_d = depth != p_depth
    err = (value - p_value).abs()
    for what, bad in (("visits", bad_v), ("depth", bad_d), ("value", err > VALUE_TOL)):
        if bool(bad.any()):
            lane = int(bad.nonzero()[0])
            fail(f"{name}: kernel and search_plain differ in {what} at lane {lane}: "
                 f"visits {visits[lane].tolist()} vs {p_visits[lane].tolist()}, "
                 f"depth {int(depth[lane])} vs {int(p_depth[lane])}, "
                 f"value {float(value[lane])!r} vs {float(p_value[lane])!r}")
    if not bool((visits.sum(1) == num_sims).all()):
        fail(f"{name}: root visits do not sum to {num_sims}")
    if bool((visits[~legal.cpu().bool()] != 0).any()):
        fail(f"{name}: an illegal root action got visits")
    if not bool(torch.isfinite(value).all()):
        fail(f"{name}: non-finite root value")
    max_err = float(err.max())
    log(f"[compare] {name}: B={visits.shape[0]} A={visits.shape[1]}: visits and "
        f"depth equal, max |dvalue| = {max_err!r}, max depth {int(depth.max())}")
    return max_err


def compare_case(name, cfg, net, B, num_players, noise, random_legal, seed):
    """Kernel vs search_plain on the same card tensors; returns max |dvalue|."""
    from muzero_general_tpu_torch.ops import mcts_fused

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = len(cfg.action_space)
    obs_shape = (B,) + tuple(cfg.observation_shape)
    obs = torch.randn(obs_shape, generator=gen, device=dev) * 0.5
    legal = torch.ones((B, A), dtype=torch.bool, device=dev)
    if random_legal:
        legal = torch.rand((B, A), generator=gen, device=dev) < 0.7
        legal[torch.arange(B, device=dev), torch.randint(
            0, A, (B,), generator=gen, device=dev)] = True
    to_play = (torch.arange(B, device=dev) % num_players).to(torch.int32)
    spec = mcts_fused.FusedSpec.from_config(cfg, deterministic_tie_break=True)
    with torch.no_grad():
        root = mcts_fused.prepare_root(net, obs, legal, to_play, gen, spec, noise)
        weights = mcts_fused.fused_weights(net, cfg.encoding_size)
        args = (root.prior, root.hidden, root.reward, root.to_play, root.legal, weights)
        kw = mcts_fused.search_kwargs(spec)
        got = mcts_fused.search(*args, **kw)
        want = mcts_fused.search_plain(*args, **kw)
    return check_equal(f"{name} (E={cfg.encoding_size}, players={num_players}, "
                       f"noise={noise}, tie jitter 0)", got, want, legal,
                       cfg.num_simulations)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from muzero_general_tpu_torch.config import MuZeroConfig as BaseConfig
    from muzero_general_tpu_torch.games.cartpole import MuZeroConfig, make_env
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.native import build
    from muzero_general_tpu_torch.ops import mcts_fused
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. the card ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"[device] torch: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build -------------------------------------------------------
    info = build.build("mcts_fused")
    log(f"[build] {SOURCE} -> {info['path'].name} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "ptxas" in line or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    build.load_library("mcts_fused")

    # ---- 3. kernel vs plain ---------------------------------------------
    cart = MuZeroConfig()
    cart_net = load_pretrained(MuZeroNetwork(cart))
    two = MuZeroConfig()
    two.players = [0, 1]
    lander = BaseConfig()
    lander.observation_shape = (1, 1, 8)
    lander.action_space = list(range(4))
    lander.encoding_size = 10
    lander.fc_dynamics_layers = [64]
    lander.fc_reward_layers = [64]
    lander.fc_value_layers = [64]
    lander.fc_policy_layers = [64]
    lander_net = MuZeroNetwork(lander, seed=1)
    cases_err = max(
        compare_case("cartpole pretrained + noise", cart, cart_net, 256, 1, True, False, 0),
        compare_case("2-player, same net", two, cart_net, 256, 2, True, True, 1),
        compare_case("lunarlander-shaped 64-wide", lander, lander_net, 256, 1, True, True, 2),
    )

    # ---- 4. the main path -----------------------------------------------
    cfg = MuZeroConfig()
    cfg.num_simulations = 50
    cfg.parallel_games = 4096
    cfg.selfplay_chunk_moves = 8
    net = load_pretrained(MuZeroNetwork(cfg))
    driver = SelfPlayDriver(make_env(), net, cfg, seed=0)
    K, reps = cfg.selfplay_chunk_moves, 3
    mcts_fused.search.launches = 0
    driver.play(temperature=1.0)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        _, stats = driver.play(temperature=1.0)
    torch.cuda.synchronize()
    chunk_s = (time.perf_counter() - t0) / reps
    launches = mcts_fused.search.launches
    moves = (reps + 1) * K
    if launches != moves:
        fail(f"main path: {launches} kernel launches for {moves} moves")
    steps_per_s = stats["env_steps"] / chunk_s
    log(f"[main] SelfPlayDriver.play: {cfg.parallel_games} lanes x "
        f"{cfg.num_simulations} sims, {K} moves/chunk: {chunk_s * 1e3:.2f} ms/chunk, "
        f"{steps_per_s:.1f} env-steps/s, kernel launches {launches} = moves {moves}, "
        f"max tree depth {stats['max_tree_depth']}")
    # play = the move loop on the device (play_chunk) + the host's episode cuts.
    temps = torch.ones((cfg.parallel_games,))
    t0 = time.perf_counter()
    for _ in range(reps):
        driver.play_chunk(temps, K)
    torch.cuda.synchronize()
    loop_s = (time.perf_counter() - t0) / reps

    # The search at the main path's state and shapes (4,096 mid-episode roots,
    # the driver's tie jitter): kernel vs search_plain, then timings.
    carry = driver._carry
    from muzero_general_tpu_torch.ops.stacking import stack_observations

    with torch.no_grad():
        stacked = stack_observations(carry.obs_hist, carry.act_hist, driver.A)
        legal = driver.env.legal_actions_mask(carry.env_state)
        to_play = driver.env.to_play(carry.env_state)
        root = mcts_fused.prepare_root(net, stacked, legal, to_play,
                                       driver.generator, driver.fused_spec)
        weights = mcts_fused.fused_weights(net, cfg.encoding_size)
        args = (root.prior, root.hidden, root.reward, root.to_play, root.legal, weights)
        kw = mcts_fused.search_kwargs(driver.fused_spec) | {"seed": 1}
        got = mcts_fused.search(*args, **kw)
        want = mcts_fused.search_plain(*args, **kw)
        main_err = check_equal(
            f"main path (tie jitter {kw['tie_jitter']!r}, seed {kw['seed']})",
            got, want, legal, cfg.num_simulations)
        kernel_ms = cuda_ms(lambda: mcts_fused.search(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: mcts_fused.search_plain(*args, **kw), 1)
    move_ms = chunk_s * 1e3 / K
    flops, nbytes = search_work(cfg.parallel_games, driver.A, cfg.encoding_size,
                                cfg.num_simulations, weights)
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"[main] kernel {kernel_ms:.4f} ms/launch (CUDA events, 20 launches), "
        f"{100 * kernel_ms / move_ms:.1f}% of {move_ms:.4f} ms/move; "
        f"search_plain {plain_ms:.2f} ms/move; bound {b_ms:.6f} ms ({b_by}: "
        f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB)")
    log(f"[main] per move: {move_ms:.4f} ms = kernel {kernel_ms:.4f} + rest of the "
        f"move loop {loop_s * 1e3 / K - kernel_ms:.4f} (play_chunk {loop_s * 1e3 / K:.4f}) "
        f"+ host episode cuts {(chunk_s - loop_s) * 1e3 / K:.4f}")

    # ---- 5. greedy check ------------------------------------------------
    gcfg = MuZeroConfig()
    gcfg.parallel_games = 64
    gdriver = SelfPlayDriver(make_env(), load_pretrained(MuZeroNetwork(gcfg)), gcfg, seed=1)
    completed, _ = gdriver.play(temperature=0.0, num_moves=500, add_noise=False)
    returns = [float(gh.rewards.sum()) for gh in completed]
    if not returns:
        fail("greedy check: no episode completed in 500 moves")
    mean_return = sum(returns) / len(returns)
    log(f"[greedy] 64 lanes, 500 moves, temperature 0: {len(returns)} episodes, "
        f"mean return {mean_return:.2f} (min {min(returns):.0f}, max {max(returns):.0f})")
    if mean_return < 100:
        fail(f"greedy check: mean return {mean_return:.2f} < 100")

    # ---- 6. results -----------------------------------------------------
    kernels = [{
        "name": "mcts_fused_search",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "visits_exact": True,  # check_equal failed the run otherwise
        "max_abs_err": main_err,  # the main path's roots, tie jitter on
        "cases_max_abs_err": cases_err,  # the three cases, tie jitter 0
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
