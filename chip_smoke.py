#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (muzero_general_tpu_torch) on one GPU.

    python3 chip_smoke.py

In order, it:
1. prints the card's name and power limit;
2. builds every kernel (csrc/mcts_fused.cu, csrc/mcts_kernels.cu,
   csrc/mcts_stream.cu, csrc/hidden_store.cu, csrc/conv3x3.cu,
   csrc/conv_probe.cu and csrc/stream_probe.cu) from the checkout, one nvcc each, started together,
   and prints the build times and ptxas' register/shared-memory report; then
   the replay batch assembler (native/replay_sampler.cpp) with g++;
3. the cartpole path (FC net, the fused-search kernel):
   a. holds the kernel against its plain PyTorch version (search_plain), tie
      jitter 0, in three cases: cartpole with the pretrained weights and
      Dirichlet noise, a 2-player search with the same net, and a 64-wide
      lunarlander-shaped net (A=4, E=10). Visits and depth must be equal,
      root values within 1e-5;
   b. runs SelfPlayDriver on cartpole at 4,096 lanes x 50 simulations,
      chunks of 8 moves, pretrained weights, tie jitter 1e-5; times 3 chunks
      and checks that the kernel was launched once per move. At the 4,096
      roots it reached, with the same tie jitter, it holds the kernel against
      search_plain as in (a) and times both, with the kernel's time per
      simulation and its share of the bound;
   c. plays 64 greedy lanes for 500 moves: mean return >= 100;
   d. replay: saves the games of (c) into the port's ReplayBuffer under the
      cartpole config; assembles a batch on the C++ assembler and on the
      numpy path from the same rng state (bit-equal, finite); checks the PER
      weights in (0, 1] with a max of 1; writes priorities back; times
      get_batch and one BatchPrefetcher.take(8) on the host and moves a
      batch onto the card;
4. the connect4 path (3 x 64 ResNet, the staged search with the planar
   descent and backprop kernels):
   a. each kernel against its plain version (descend_planar_plain,
      backprop_plain) on a real tree snapshot at 256 lanes taken after 100
      of 200 simulations, tie jitter 1e-5: descend outputs, visits, value
      sums and min/max must be equal; each timed as the median of 5 CUDA
      graphs of 50 launches, with its time per level of the deepest lane,
      and the backprop's floor (the same launch with every leaf depth -1);
   b. runs SelfPlayDriver on connect4 with the pretrained weights at 256
      lanes x 200 simulations, chunks of 8 moves; times 3 chunks after a
      warm-up (their games are phase 12d's replay data), the move loop
      inside them apart from the host's episode
      cuts; checks that each kernel was launched 200 times per move; times
      the network's and the kernels' device work by CUDA graph replay and
      profiles one move for the card's busy share; then replay as in 3d on
      the two-player games the chunks completed, under the connect4 config;
   c. at the 256 mid-game roots the driver reached, runs the whole search
      on the kernel route and on the kernels' plain versions, same root
      noise and jitter seed, cuDNN deterministic: visits and depth must be
      equal, root values within 1e-5;
   d. plays 64 games of pretrained MuZero (first to move, temperature 0
      with root noise) against the env's expert: MuZero must win >= 48;
   the same at 8 leaves per round (multi-leaf search: the marking descent
   and the pre-marked backprop):
   e. each mode against its plain version on a real 256-lane tree after 96
      of 200 simulations (12 rounds), tie jitter 1e-5, over the next round's
      8 selections: descend outputs and the marked slab at each selection,
      then the 8 paths' backprops (visits unchanged, value sums, root stats,
      min/max) must be equal; the marking descent and the first path's
      pre-marked backprop timed as in (a), with the backprop's floor;
   f. runs SelfPlayDriver at 256 lanes x 200 simulations in 25 rounds of 8,
      chunks of 8 moves, as in (b); checks 200 launches of each mode per
      move and none of the unmarked ones, 25 recurrent inferences of 2,048
      leaves per move and the visit policies (sum 1, none on a full column);
      times the device work and profiles one move;
   g. the whole K = 8 search, kernel route vs plain versions, as in (c);
   h. 64 games against the expert as in (d), recorded, not a gate;
   b and f also count the folded net's fused 3x3 conv (kernel 11,
   csrc/conv3x3.cu) from zero: every conv that ops/conv3x3.py's routing
   rule sends to the kernel launched it once;
   i. kernel 11 against its plain version (conv3x3_plain: F.conv2d, bias,
      skip, ReLU, float32 without TF32) on the same seeded inputs at
      [1,024 | 2,048, 3 | 64 | 65 -> 64, 6, 7], with and without the skip:
      every output within the float32-sum bound of their difference,
      2 gamma_k sum |term| (k = 9 Cin + 2), and the kernel within
      gamma_k sum |term| of a float64 conv; each timed as 20 chained calls
      in one CUDA graph beside the plain version, with bound_ms from the
      shape's FLOPs and bytes;
6. the node-major descent (the counterpart of tools/resnet_profile.py
   section 4b) on the end-state tree of (c): kernel vs plain and vs the
   planar kernel on the same tree, bit-equal with tie jitter on; both
   layouts timed;
7. the hidden-store row write (the counterpart of
   tools/hidden_store_bench.py, [201, 256, 2688]): kernel vs plain,
   bit-equal, every other row unchanged; the bench's 200-simulation loop;
   one write beside store[node].copy_(leaf), in turns, with its share of
   the bound and its ratio to copy_;
8. the gomoku path (the shipped 6 x 128 ResNet, seeded random weights, f32;
   the staged search's stream route with the stream descent and edge-update
   kernels):
   a. each kernel against its plain version (descend_stream_plain,
      update_edges_plain) on a real 64-lane packed slab taken after 200 of
      400 simulations, tie jitter 1e-5: all eight descend outputs equal; the
      slab's live rows after an update equal, with every 8th lane cut to a
      depth-1 leaf while the bound stays the deepest lane's, so masked
      levels (aimed at the dummy row) are exercised; each timed as the
      median of 5 CUDA graphs of 50 launches, the descent's time per level
      of its deepest lane, and the update's floor (the same launch with
      bound 0);
   b. runs SelfPlayDriver on gomoku at 64 lanes x 400 simulations, chunks of
      2 moves; times 1 chunk after a warm-up, the move loop apart from the
      host's episode cuts; checks the stream route with the BN folded, 400
      launches of each kernel per move and the visit policies (sum 1, none
      on an occupied cell); times the network's and the kernels' device work
      by CUDA graph replay and profiles one move for the card's busy share;
   c. at the 64 mid-game roots the driver reached, runs the whole
      400-simulation search on the kernel route and on the plain versions,
      as in 4c;
9. the conv probe (kernels 8 and 9, the counterpart of tools/conv_probe.py)
   at [64, 11, 11, 128] in bf16 and f32 and at connect4's 2,048 leaves
   [2048, 6, 7, 64] in bf16: each kernel against its plain version (bf16
   within 8e-3 of max |plain|, f32 1e-5), then the probe's entry point,
   which holds each kernel against the library conv (< 2e-2) and times 50
   chained applications of each engine in one CUDA graph;
10. the stream probe (kernel 10, the counterpart of tools/stream_probe.py)
   at [64, 512, 8, 128]: the kernel against its plain version for 0, 64 and
   128 levels (1e-5 relative); its device time at each (CUDA graphs; L = 0
   is floor_ms) and one call with the L2 warm and cold (after a 256 MB
   write); then the probe's entry point (the float64 reference at rtol
   1e-4, the time per level), beside the stream descent's time per level
   from 8a;
11. the board-game lanes at the JAX bench's compute dtype, bfloat16:
   connect4 K = 1 (pretrained, 256 lanes x 200 sims, the 64-game gate
   against the expert), connect4 K = 8 with bf16 search activations (the
   whole-search check of 4c) and gomoku (64 lanes x 400 sims); each timed
   as in 4b (one timed chunk: connect4 K = 1's of 4 moves, K = 8's of 8,
   gomoku's of 1 move), profiled for one move, and
   checked to run its convs on bf16 weights with the hidden store in its
   activation dtype;
12. the learner (trainer.py), on replay batches from the games of 3d and 4b:
   a. cartpole's main path (batch 128, unroll 10, Adam, PER, 8 fused
      steps, remat) from the shipped checkpoint and its Adam state: one
      fused call on the card against the same call on the CPU (losses,
      priorities, params, Adam moments; tolerances at LEARN_F32);
   b. the card's train-step rate over 4 fused calls, the host's batch
      assembly timed apart; one fused call profiled (launches per step,
      the card's busy share);
   c. the learn loop, 4 rounds of: play a chunk (1,024 lanes, the fused
      kernel), save the completed games, take 8 batches, one fused train
      call, write the priorities back, hand the weights to the driver; after
      each hand-off the driver's next search on the card against
      search_plain on the learner's module (bit-equal, as in 3b); each
      stage's ms; then a sync_checkpoint / save / load / restore round
      trip whose next fused call must equal the original's bit for bit;
   d. connect4's 3 x 64 ResNet (batch 64, unroll 42) from the shipped
      checkpoint, in f32 and bf16: one step on the card against the CPU's
      (running statistics included), and the card's rate;
   e. gomoku's full config (6 x 128, batch 512, unroll 121) in bf16 with
      remat: one step's time and peak memory; at batch 16, remat against
      the plain unroll, bit-equal (cuDNN deterministic);
13. orchestration (muzero.py, evaluate.py), through the user's entry points:
   a. MuZero("cartpole", {"training_steps": 200}).train() at the shipped
      width (16 lanes x 50 simulations, batch 128, unroll 10, 8 fused
      steps, the prefetcher): train steps/s, env-steps/s, the phase split,
      the fused search's launches, the last greedy reward; then
      test(num_tests=2), the fused search at G = 1, its first 6 launches
      held against search_plain on the same inputs (visits exact);
   b. load_model of (a)'s checkpoint and replay buffer: the learner resumes
      at step 200 with (a)'s weights bit for bit, and trains 8 more steps;
   c. MuZero("connect4", 64 lanes, 16 steps).train(), across one opponent
      evaluation game (the B = 1 search; its route printed) and the planar
      kernels' launches in self-play; the phase split;
   d. the shipped connect4 checkpoint: test(opponent="expert", num_tests=1),
      the result recorded (not gated; one game, as each MuZero move's B = 1
      search on the plain-op route takes seconds on the card: a depth cut
      from 4, which keeps the whole script inside its time limit);
   e. `python -m muzero_general_tpu_torch cartpole '{"training_steps": 16,
      ...}'` in a subprocess: rc 0 and a checkpoint written;
14. the remaining device games and the diagnosis (diagnose.py):
   a. one SelfPlayDriver chunk each at the shipped widths, seeded random
      weights: gridworld (FC, 32 lanes x 20 sims, the fused kernel),
      twentyone (2 x 32 ResNet, 64 lanes x 21 sims) and breakout (2 x 16
      ResNet on 96 x 96 frames downsampled to 6 x 6, 8 lanes x 30 sims), the
      last two on the planar kernels; every launch of that chunk held
      against its plain version (CheckedLaunches), then 3 timed chunks
      (env-steps/s, ms a move, launches); breakout's initial inference (the
      downsample pyramid) and recurrent inference, device ms by graph replay;
   b. the breakout net from one seed, random batch norms, on the card
      against the CPU at the driver's observations: f32 and bf16 (bf16
      activations when folded), unfolded and folded (NET_F32_TOL,
      NET_BF16_TOL);
   c. MuZero(game, {"training_steps": 16}).train() then test(num_tests=1)
      for the three games at their shipped widths (breakout's max_moves cut
      to BREAKOUT_MAX_MOVES): launches, the phase split, gridworld's test()
      searches at G = 1 held against search_plain, the others' B = 1 search
      on the plain-op route (no launch); one breakout learner step from
      that run's checkpoint and replay buffer, card against CPU (LEARN_F32);
   d. DiagnoseModel on gridworld's trained checkpoint (horizon 5) and the
      shipped connect4 one (horizon 1: its B = 1 searches are host-bound):
      compare_virtual_with_real_trajectories, then the plots
      into a temporary directory where matplotlib, seaborn and graphviz are
      installed; the search's route (plain-op at B = 1) and no launch;
15. the Gumbel search (ops/gumbel.py) and device replay
   (ops/device_replay.py), neither with a kernel of its own, as in JAX:
   a. run_gumbel_mcts on the card against the same call on the CPU with the
      same injected Gumbel draw: a table network (64 lanes x 50 sims, two
      players, m 16 and 4; trees, depths and both actions exact, root
      values within GUMBEL_VALUE_RTOL), then the shipped cartpole net (256
      lanes x 16 sims) and the shipped connect4 net (16 lanes x 200 sims):
      the invariants (visit sums, each lane's visits following the halving
      table for its m, none on illegal actions, the improved policy summing
      to 1), the shares of lanes whose root visits and whole trees equal
      the CPU's, and the latter's root values within GUMBEL_NET_VALUE_ATOL;
   b. Gumbel self-play, the driver on the staged route: cartpole 4,096
      lanes x 16 sims (m 16), 1 timed chunk of 8 moves; connect4's shipped
      net, 64 lanes x 200 sims, 1 timed chunk of GUMBEL_C4_CHUNK_MOVES
      (depth cuts); ms a move, env-steps/s, one move profiled for its
      device launches per simulation, and no launch of the port's search
      kernels (the folded connect4 net's representation conv at 64 lanes
      runs kernel 11, once a move, as ops/conv3x3.py's rule says);
   c. MuZero("cartpole", {"use_gumbel_mcts": True, "num_simulations": 16,
      "gumbel_max_considered_actions": 16, "training_steps":
      GUMBEL_TRAIN_STEPS}).train(), then test(num_tests=1) on the G = 1
      Gumbel search;
   d. device replay card against CPU: rings filled from the games of 3d and
      4b (save_games), batches on forced draws (equal but float32 sums,
      within RING_ULPS), one make_device_train call at M = 8 from the
      shipped cartpole checkpoint and its Adam state (LEARN_F32), with no
      batch copied from the host;
   e. MuZero("cartpole", {"training_steps": 200, "device_replay":
      True}).train() beside 13a's host-replay run: train steps/s, the phase
      split, the device rounds and single host steps, host-to-card batch
      copies in the rounds (must be 0), reanalyse sweeps mirrored into the
      ring, and kernel 1's launches in its self-play;
16. the host-env path (hostplay.py) on numpy stand-ins with the host
   games' shapes (this machine has no gymnasium, cv2, ale-py or pyspiel),
   and the hyperparameter search (search.py):
   a. lunarlander's shipped width (FC, encoding 10, 64-wide, support 10;
      16 lanes x 50 simulations, chunks of 8 moves) on a seeded stand-in
      with (1, 1, 8) observations and 4 actions, host_pipeline off and on:
      the first move's every planar descent and backprop launch held
      against its plain version, then 1 timed chunk (ms a move,
      env-steps/s, launches: one per simulation of each dispatch) and one
      move profiled (launches per simulation, the card's busy share);
   b. MuZero("lunarlander", {"training_steps": 16}).train() with make_env
      swapped for the stand-in, then test() at G = 1 (the host driver) and
      test(opponent="random") (evaluate.py's host branch), one game each;
   c. spiel's two-player 1 x 16 ResNet (16 lanes x 25 simulations) on a
      numpy tic-tac-toe with pyspiel's surface, through SpielGame(game=...):
      one chunk, every launch held against its plain version;
   d. atari's network at its shipped width (the downsample ResNet, 16
      blocks x 256 channels, 32 stacked frames, support 300, bf16) on 350
      lanes x 50 simulations of seeded (3, 96, 96) frames: one move with
      every launch checked, one timed and one profiled;
   e. one_plus_one_search on cartpole, budget 2, parallel_experiments 2,
      tiny candidates: on one card the slices collide and the candidates
      run one after the other; their scores and the best;
17. the mesh (parallel/): two ranks on cuda:0, started by
   parallel.distributed.launch, meeting over gloo, which the port picks for
   ranks sharing a card (NCCL refuses two ranks on one card; gloo stages
   the collectives' CUDA tensors through the host):
   a. cartpole's FC net, dp = 2: one sharded SGD step on each rank's rows of
      a seeded global batch against the single-rank step on the whole
      batch (loss 1e-5 relative, priorities rtol 1e-4 atol 1e-5, updates
      rtol 5e-3 atol 1e-6), then the sharded step's ms, one rank's and the
      gradient all_reduce's;
   b. the same for connect4's ResNet (Adam, the global batch norm), from
      seed 0's weights with a fresh Adam state (unroll cut to 5, where one
      rank's float32 step is well-conditioned; each step also against the
      float64 step) and from the shipped checkpoint with its own (unroll
      42): losses 1e-4 relative, >= 99% of params within 1e-5 and the
      running statistics (phase 12's rule);
   c. an mp = 2 step of the 512-wide FC net (column-parallel layers);
   d. after each step the ranks' parameters are bit-identical;
   e. self-play with the sharded driver: cartpole at 2 x 2,048 lanes x 50
      simulations and connect4 at 2 x 128 lanes x 200, the shipped weights:
      each rank's first move with every launch of kernels 1, 2 and 3 held
      against its plain version, then timed moves (ms a move per rank);
   f. global_sum of the ranks' env steps;
   g. multi-host training: two processes, each
      MuZero("cartpole", {"training_steps": 50}, distributed={...,
      "backend": "gloo"}).train(): weights equal at the end, rank 0 alone
      writing files;
18. the port's tools (muzero_general_tpu_torch/tools/), in process at
   reduced sizes: gpu_parity (the fused, staged and stream kernels against
   the plain-op route; it must exit 0), resnet_profile at connect4 64 x 50
   (kernel 6 checked against descend_plain on a plain-op search's end-state
   tree, then timed), hidden_store_bench at [201, 256, 2688] (the three
   final stores bit-equal, kernel 7 launched 800 times), trace_search (a
   connect4 64 x 50 move on the kernel route, 50 launches of each tree
   kernel, and on the plain-op route, none) and trace_train (cartpole's
   learner, batch 128, fused 2);
19. prints one {"kernels": [...]} JSON line (the fused search's entry with
   its train() and test() launches and 15e's under
   "cartpole_device_replay_train_launches" and 16e's under
   "hyperparameter_search_launches", the planar kernels' with connect4's
   train() launches, each with the launches of phase 14's games under
   "<game>_selfplay_launches", "<game>_train_launches" and
   "<game>_test_launches", phase 16's under "<game>_host_*_launches" and
   phase 17's per rank under "<kernel>_mesh_launches" and
   "mcts_fused_search_mesh_train_launches", and phase 18's by tool under
   "<kernel>_tool_launches", kernel 6's "descend_node_major_tool_launches"),
   then ends with {"ok": true,
   "device": {...}}.

It exits non-zero, printing no result, when no CUDA card is present or any
phase fails. It imports nothing of JAX.
"""

import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

from muzero_general_tpu_torch.tools.profiling import device_trace
from muzero_general_tpu_torch.tools.profiling import launch_counts as kernel_counts

REPO = pathlib.Path(__file__).resolve().parent
CART_CHECKPOINT = REPO / "pretrained" / "cartpole" / "model.checkpoint"
C4_CHECKPOINT = REPO / "pretrained" / "connect4" / "model.checkpoint"
CSRC = "muzero_general_tpu_torch/csrc/"
# One H100 SXM at its 700 W limit (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense bfloat16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
VALUE_TOL = 1e-5
QUALITY_GAMES, QUALITY_WINS = 64, 48
# The designs of the redesigned search kernels, for the kernels line.
FUSED_DESIGN = ("a lane a group of 16 threads (two a warp) where the block's eight trees fit "
                "its shared memory, else 32; the three heads' layers in joint passes; decodes "
                "and softmax across the group, sums sequential on one thread each; numerator "
                "and reciprocal tables, redux argmax, Philox only where the jitter can decide")
DESCEND_DESIGN = ("one warp per lane, one lane a block, seven more warps building the tables; "
                  "each thread one action's five loads issued together, one round trip a level "
                  "(two passes above 32 actions); redux visit sum and argmax, the winner's "
                  "child shuffled from its owner; numerator table and a predicted count (a "
                  "miss redoes one product), exact table division")
BACKPROP_DESIGN = ("one warp per lane, a thread per path entry; round trip 1 the lane's scalars "
                   "and first 32 path entries together, round trip 2 every live edge's visit, "
                   "value sum and reward; only the value chain serial (a shuffle and two flops "
                   "a level), each level's division and stat on its owner, min/max by redux "
                   "over order-preserving keys; chunks of 32 from the leaf end, a chunk that "
                   "repeats an edge (__match_any_sync) walked serially")
CHASE_DESIGN = ("a lane a block of two warps: the chaser thread loads only each row's pointer "
                "word (a relaxed gpu-scope load) and issues a bulk asynchronous copy "
                "(cp.async.bulk) of the row into a ring of up to 8 shared-memory stages with "
                "full and empty mbarriers; the consumer warp sums each stage as it lands, eight "
                "16-byte words a lane at once, into per-lane shares added once at the end")
UPDATE_DESIGN = ("a thread per (level, lane) slot; the bound and the slot's mask, node, action "
                 "and delta issued together (round trip 1), then a live slot's visit and value "
                 "sum (round trip 2) and the two stores")


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


def graph_ms(fn, reps):
    """Mean device time of fn() with the host out of the way: reps calls
    captured in one CUDA graph, replayed (after a warm replay) between CUDA
    events. For kernels shorter than their own launch from Python."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, 1) / reps


def bound_ms(flops, nbytes, peak_flops=PEAK_F32_FLOPS):
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def timed_play(driver, reps, games=None):
    """One warm-up driver.play chunk, then `reps` timed ones. The move loop
    (play_chunk) is timed inside the same calls, so the split between it and
    the host's episode cuts sees no drift. Returns (seconds per chunk, ms
    per move of the move loop, the last chunk's stats, every chunk's
    MoveRecord, the warm-up's included); the games the chunks completed
    are added to `games` where it is a list."""
    chunk_times, records = [], []
    play_chunk = driver.play_chunk

    def timed_play_chunk(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = play_chunk(*args, **kwargs)
        torch.cuda.synchronize()
        chunk_times.append(time.perf_counter() - t)
        records.append(out)
        return out

    driver.play_chunk = timed_play_chunk
    try:
        completed, _ = driver.play(temperature=1.0)  # warm-up
        chunk_times.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            done, stats = driver.play(temperature=1.0)
            completed += done
        torch.cuda.synchronize()
        chunk_s = (time.perf_counter() - t0) / reps
    finally:
        del driver.play_chunk
    if games is not None:
        games += completed
    loop_ms = sum(chunk_times) * 1e3 / (reps * driver.config.selfplay_chunk_moves)
    return chunk_s, loop_ms, stats, records


def network_ms(folded, driver, leaves=1, reps=20, init_reps=5):
    """The device time of one recurrent inference at the driver's batch
    times `leaves` and of one initial inference (CUDA graph replay), and of
    a recurrent call from Python (CUDA events)."""
    with torch.no_grad():
        obs = driver.env.observation(driver._carry.env_state)
        hidden = folded.initial_inference(obs)[3].repeat(leaves, 1, 1, 1)
        action = torch.zeros((leaves * driver.G,), dtype=torch.long, device=hidden.device)

        def recurrent():
            return folded.recurrent_inference(hidden, action)

        rec_call = cuda_ms(recurrent, reps)
        rec_ms = graph_ms(recurrent, reps)
        init_ms = graph_ms(lambda: folded.initial_inference(obs), init_reps)
    return rec_ms, init_ms, rec_call


def load_pretrained(net, path):
    from muzero_general_tpu_torch.checkpoint import load_checkpoint
    from muzero_general_tpu_torch.models import params_from_jax

    net.load_state_dict(params_from_jax(load_checkpoint(path)["weights"]))
    return net


def build_kernels():
    from muzero_general_tpu_torch.native import build

    t0 = time.perf_counter()
    infos = build.build_all()
    log(f"[build] {len(infos)} kernels built together in {time.perf_counter() - t0:.2f} s")
    for name, info in infos.items():
        log(f"[build] {CSRC}{name}.cu -> {info['path'].name} in {info['seconds']:.2f} s")
        # ptxas -v: registers, shared memory and spills of every kernel
        for line in info["log"].splitlines():
            if "ptxas" in line or "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")
        build.load_library(name)
    t0 = time.perf_counter()
    info = build.build_replay_native()
    build.load_replay_native()
    log(f"[build] muzero_general_tpu_torch/native/replay_sampler.cpp (g++) -> "
        f"{info['path'].name} in {info['seconds']:.2f} s ({time.perf_counter() - t0:.2f} s "
        f"with the import)")


# ---------------------------------------------------------------------------
# The cartpole path: the fused-search kernel
# ---------------------------------------------------------------------------


def search_work(B, A, E, num_sims, weights):
    """(FLOPs, bytes) of one fused search: the MLP arithmetic the simulations
    need (descent and backprop arithmetic left out: data-dependent and
    smaller), and each input read and each output written once."""
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


def check_equal(name, got, want, legal, num_sims, quiet=False):
    """Fail unless (visits, value, depth) equal the plain version's: visits
    and depth exactly, values within VALUE_TOL; every root's visits sum to
    num_sims and illegal actions get none. Returns max |dvalue| (logged
    unless `quiet`)."""
    torch.cuda.synchronize()
    visits, value, depth = (t.cpu() for t in got)
    p_visits, p_value, p_depth = (t.cpu() for t in want)
    bad_v = (visits != p_visits).any(1)
    bad_d = depth != p_depth
    err = (value - p_value).abs()
    for what, bad in (("visits", bad_v), ("depth", bad_d), ("value", err > VALUE_TOL)):
        if bool(bad.any()):
            lane = int(bad.nonzero()[0])
            fail(f"{name}: kernel and plain version differ in {what} at lane {lane}: "
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
    if not quiet:
        log(f"[compare] {name}: B={visits.shape[0]} A={visits.shape[1]}: visits and "
            f"depth equal, max |dvalue| = {max_err!r}, max depth {int(depth.max())}")
    return max_err


def compare_case(name, cfg, net, B, num_players, noise, random_legal, seed):
    """Fused kernel vs search_plain on the same card tensors; max |dvalue|."""
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


def cartpole_path():
    """Phases 3a-3d; returns the replay buffer of 3d and the fused kernel's
    entry of the kernels line."""
    from muzero_general_tpu_torch.config import MuZeroConfig as BaseConfig
    from muzero_general_tpu_torch.games.cartpole import MuZeroConfig, make_env
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.ops import mcts_fused
    from muzero_general_tpu_torch.ops.stacking import stack_observations
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    # ---- 3a. kernel vs plain --------------------------------------------
    cart = MuZeroConfig()
    cart_net = load_pretrained(MuZeroNetwork(cart), CART_CHECKPOINT)
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

    # ---- 3b. the main path ----------------------------------------------
    cfg = MuZeroConfig()
    cfg.num_simulations = 50
    cfg.parallel_games = 4096
    cfg.selfplay_chunk_moves = 8
    net = load_pretrained(MuZeroNetwork(cfg), CART_CHECKPOINT)
    driver = SelfPlayDriver(make_env(), net, cfg, seed=0)
    if not driver.use_fused:
        fail("cartpole: the driver did not route to the fused search")
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
        fail(f"cartpole main path: {launches} kernel launches for {moves} moves")
    steps_per_s = stats["env_steps"] / chunk_s
    log(f"[cartpole] SelfPlayDriver.play: {cfg.parallel_games} lanes x "
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
            f"cartpole main path (tie jitter {kw['tie_jitter']!r}, seed {kw['seed']})",
            got, want, legal, cfg.num_simulations)
        kernel_ms = cuda_ms(lambda: mcts_fused.search(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: mcts_fused.search_plain(*args, **kw), 1)
    move_ms = chunk_s * 1e3 / K
    flops, nbytes = search_work(cfg.parallel_games, driver.A, cfg.encoding_size,
                                cfg.num_simulations, weights)
    b_ms, b_by = bound_ms(flops, nbytes)
    per_sim_us = 1e3 * kernel_ms / cfg.num_simulations
    log(f"[cartpole] kernel {kernel_ms:.4f} ms/launch (CUDA events, 20 launches), "
        f"{100 * kernel_ms / move_ms:.1f}% of {move_ms:.4f} ms/move; "
        f"search_plain {plain_ms:.2f} ms/move; bound {b_ms:.6f} ms ({b_by}: "
        f"{flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.4f} MB)")
    log(f"[cartpole] kernel per simulation (all {cfg.parallel_games} lanes): "
        f"{per_sim_us:.3f} us; bound share {100 * b_ms / kernel_ms:.3f}% of the kernel's time")
    log(f"[cartpole] per move: {move_ms:.4f} ms = kernel {kernel_ms:.4f} + rest of the "
        f"move loop {loop_s * 1e3 / K - kernel_ms:.4f} (play_chunk {loop_s * 1e3 / K:.4f}) "
        f"+ host episode cuts {(chunk_s - loop_s) * 1e3 / K:.4f}")

    # ---- 3c. greedy check ------------------------------------------------
    gcfg = MuZeroConfig()
    gcfg.parallel_games = 64
    gdriver = SelfPlayDriver(make_env(), load_pretrained(MuZeroNetwork(gcfg), CART_CHECKPOINT),
                             gcfg, seed=1)
    completed, _ = gdriver.play(temperature=0.0, num_moves=500, add_noise=False)
    returns = [float(gh.rewards.sum()) for gh in completed]
    if not returns:
        fail("cartpole greedy check: no episode completed in 500 moves")
    mean_return = sum(returns) / len(returns)
    log(f"[cartpole] greedy: 64 lanes, 500 moves, temperature 0: {len(returns)} episodes, "
        f"mean return {mean_return:.2f} (min {min(returns):.0f}, max {max(returns):.0f})")
    if mean_return < 100:
        fail(f"cartpole greedy check: mean return {mean_return:.2f} < 100")

    # ---- 3d. replay ------------------------------------------------------
    cart_replay = replay_phase("cartpole replay", MuZeroConfig(), completed)
    return cart_replay, {
        "name": "mcts_fused_search",
        "route": "cuda",
        "source": CSRC + "mcts_fused.cu",
        "replaces": "muzero_general_tpu/ops/mcts_fused.py:235",
        "design": FUSED_DESIGN,
        "per_sim_us": per_sim_us,
        "launches": launches,
        "visits_exact": True,  # check_equal failed the run otherwise
        "max_abs_err": main_err,  # the main path's roots, tie jitter on
        "cases_max_abs_err": cases_err,  # the three cases, tie jitter 0
        "ms": kernel_ms,
        # 20 launches back to back: at ~1.9 ms each the host's launch cost
        # hides behind the kernel, so a call's time is the card's.
        "call_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,  # no single PyTorch call runs an MCTS
    }


# ---------------------------------------------------------------------------
# Replay: the PER buffer and the C++ batch assembler on the driver's games
# ---------------------------------------------------------------------------


def replay_phase(label, cfg, games, seed=0):
    """Phases 3d and 4b': the games the port's self-play driver completed,
    saved into the port's ReplayBuffer under the game's config; a batch
    assembled on the C++ assembler and on the numpy path from the same rng
    state (bit-equal, finite); the PER weights in (0, 1] with a max of 1;
    priorities written back; get_batch and one BatchPrefetcher.take(8) timed
    on the host, and a batch moved onto the card. Returns the buffer."""
    import numpy as np

    from muzero_general_tpu_torch.prefetch import BatchPrefetcher
    from muzero_general_tpu_torch.replay import ReplayBuffer

    if not games:
        fail(f"{label}: the driver completed no game")
    buf = ReplayBuffer(cfg)
    t0 = time.perf_counter()
    for gh in games:
        buf.save_game(gh)
    save_ms = (time.perf_counter() - t0) * 1e3
    players = sorted({int(p) for gh in games for p in np.unique(gh.to_play[:-1])})

    batches = []
    for use_native in (True, False):
        buf.rng = np.random.default_rng(seed)
        batches.append(buf.get_batch(use_native=use_native))
    (index_batch, batch), (want_index, want) = batches
    if not np.array_equal(index_batch, want_index):
        fail(f"{label}: the native and numpy paths sampled different positions")
    for key, value in want.items():
        got = batch[key]
        if (got.dtype != value.dtype or got.shape != value.shape
                or not np.array_equal(got.view(np.uint8), value.view(np.uint8))):
            fail(f"{label}: the native and numpy batches differ in {key}")
        if got.dtype.kind == "f" and not np.isfinite(got).all():
            fail(f"{label}: {key} is not finite")
    weight = batch["weight"]  # both games' configs sample with PER
    if not ((weight > 0).all() and (weight <= 1).all() and weight.max() == 1):
        fail(f"{label}: PER weights outside (0, 1] or without a max of 1: {weight}")

    # Priorities written back, as the learner will: one per unroll step.
    prio = np.random.default_rng(seed).uniform(0.01, 1.0, batch["target_value"].shape)
    prio = prio.astype(np.float32)
    buf.update_priorities(prio, index_batch)
    last = {int(gid): i for i, gid in enumerate(index_batch[:, 0])}
    for gid, i in last.items():
        gh, pos = buf.buffer[gid], int(index_batch[i, 1])
        end = min(pos + prio.shape[1], len(gh))
        if (not np.array_equal(gh.priorities[pos:end], prio[i, : end - pos])
                or gh.game_priority != float(gh.priorities.max())):
            fail(f"{label}: priorities of game {gid} not written back")

    def host_ms(fn, reps):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    native_ms = host_ms(lambda: buf.get_batch(), 20)
    numpy_ms = host_ms(lambda: buf.get_batch(use_native=False), 5)
    prefetcher = BatchPrefetcher(buf, depth=8)
    try:
        t = time.perf_counter()
        taken = prefetcher.take(8)
        take_ms = (time.perf_counter() - t) * 1e3
    finally:
        prefetcher.stop()
    if len(taken) != 8 or prefetcher._thread.is_alive():
        fail(f"{label}: the prefetcher did not hand over 8 batches and stop")
    torch.cuda.synchronize()
    t = time.perf_counter()
    on_card = {key: torch.from_numpy(value).to("cuda") for key, value in taken[-1][1].items()}
    torch.cuda.synchronize()
    to_card_ms = (time.perf_counter() - t) * 1e3
    if not all(bool(torch.isfinite(v).all()) for v in on_card.values() if v.is_floating_point()):
        fail(f"{label}: a batch on the card holds non-finite values")
    nbytes = sum(v.numel() * v.element_size() for v in on_card.values())
    log(f"[{label}] {len(games)} games ({buf.total_samples} positions, players {players}) saved "
        f"in {save_ms:.2f} ms; batch {cfg.batch_size} x {cfg.num_unroll_steps + 1} steps, "
        f"observation {tuple(batch['observation'].shape[1:])}: native and numpy batches "
        f"bit-equal, PER weights in [{weight.min():.4g}, 1]; priorities of {len(last)} games "
        f"written back")
    log(f"[{label}] host ms: get_batch {native_ms:.3f} (C++ assembler, median of 20), numpy "
        f"path {numpy_ms:.3f} (median of 5), BatchPrefetcher.take(8) {take_ms:.3f} from a "
        f"cold start; one batch onto the card {to_card_ms:.3f} ({nbytes / 1e6:.3f} MB)")
    return buf


# ---------------------------------------------------------------------------
# The connect4 path: the ResNet through the staged search's two kernels
# ---------------------------------------------------------------------------


def descend_work(leaf_depth, depth_bound, B, A, D, marked=False):
    """(FLOPs, bytes) one descent needs for this data: per level a lane
    descends, its node's A edges of four stats and the chosen child's index
    (marked: and the taken edge's visit written back), about 10 operations
    per edge plus a log, a sqrt and a few for the node; the root's legal row
    and the min/max once, and every output once. The same for both
    layouts."""
    cut = torch.where(leaf_depth < 0, depth_bound, leaf_depth)
    levels = int(cut.sum())
    flops = levels * (10 * A + 8)
    nbytes = (levels * (4 * 4 * A + 4 + (4 if marked else 0)) + 4 * (B * A + 2 * B + 1)
              + 4 * (3 * B + 2 * B * D))
    return flops, nbytes


def backprop_work(leaf_depth, B, pre_marked=False):
    """(FLOPs, bytes) one backprop needs for this data: per node on a path
    its edge's path entries, visit read (and written, unless pre-marked),
    value sum read and written and reward read, about 10 operations; per
    lane its leaf and root scalars."""
    levels = int((leaf_depth + 1).clamp(min=0).sum())
    flops = levels * 10
    nbytes = levels * (8 + (12 if pre_marked else 16) + 4) + B * 4 * (2 + 1 + 2 * 4)
    return flops, nbytes


def random_positions(env, B, plies, gen):
    """B connect4 positions `plies` random legal moves into a game."""
    state = env.reset(B, gen)
    for _ in range(plies):
        state, _, _ = env.step(state, env.random_legal_action(state, gen), gen)
    return state


def snapshot_checks(cfg, folded, env):
    """Phase 4a: each kernel vs its plain version on a real tree after 100 of
    200 simulations at 256 lanes. Returns per-kernel numbers."""
    from muzero_general_tpu_torch.ops import mcts as mcts_ops
    from muzero_general_tpu_torch.ops import mcts_kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    B, N, A = cfg.parallel_games, cfg.num_simulations + 1, len(cfg.action_space)
    D = cfg.num_simulations + 1
    spec = mcts_ops.SearchSpec.from_config(cfg, B, dev)
    if not spec.use_kernels:
        fail("connect4 at 256 lanes did not take the kernel route")
    state = random_positions(env, B, 6, gen)
    obs, legal, to_play = env.observation(state), env.legal_actions_mask(state), env.to_play(state)
    sim, seed = cfg.num_simulations // 2, 12345
    with torch.no_grad():
        out = mcts_ops.run_mcts(folded.initial_inference, folded.recurrent_inference, obs,
                                legal, to_play, gen, spec, seed=seed, num_steps=sim)
    tree = mcts_ops._to_planar(out.tree)
    depth_bound = (out.max_tree_depth.max() + 1).to(torch.int32)
    legal_i32 = legal.to(torch.int32).contiguous()
    dargs = (seed, sim, depth_bound, tree.children_index, tree.children_prior,
             tree.children_visit, tree.children_vsum, tree.children_reward, legal_i32,
             tree.min_value, tree.max_value)
    dkw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
               pb_c_init=spec.pb_c_init, discount=spec.discount,
               max_depth=spec.max_depth, tie_jitter=spec.tie_jitter)
    got = mcts_kernels.descend_planar(*dargs, **dkw)
    want = mcts_kernels.descend_planar_plain(*dargs, **dkw)
    torch.cuda.synchronize()
    d_err = check_equal_tensors("descend_planar", got, want,
                                ("parent", "action", "leaf_depth", "path_nodes", "path_actions"))
    leaf_depth = got[2]
    if bool((leaf_depth < 1).any()):
        fail("descend_planar: a lane was cut by the depth bound")
    log(f"[connect4] descend_planar vs plain at a {B}-lane tree after {sim} sims, "
        f"tie jitter {spec.tie_jitter!r}: all five outputs equal; leaf depths "
        f"{int(leaf_depth.min())}-{int(leaf_depth.max())}, depth bound {int(depth_bound)}")

    leaf_value = torch.randn((B,), generator=gen, device=dev) * 3
    slabs = ("children_visit", "children_vsum", "root_visit", "root_vsum", "min_value",
             "max_value")

    def bp_args(t, depth=None):
        return (got[3], got[4], leaf_depth if depth is None else depth, leaf_value,
                t.children_visit, t.children_vsum, t.children_reward, t.root_visit, t.root_vsum,
                t.root_reward, t.min_value, t.max_value)

    bkw = dict(num_players=spec.num_players, discount=spec.discount, planar=True)
    k_tree = mcts_ops.Tree(*(x.clone() for x in tree))
    p_tree = mcts_ops.Tree(*(x.clone() for x in tree))
    k_out = mcts_kernels.backprop(*bp_args(k_tree), **bkw)
    p_out = mcts_kernels.backprop_plain(*bp_args(p_tree), **bkw)
    torch.cuda.synchronize()
    bp_err = check_equal_tensors("backprop", k_out, p_out, slabs)
    changed = int((k_tree.children_visit != tree.children_visit).sum())
    if changed != int(leaf_depth.sum()):
        fail(f"backprop: {changed} edge visits changed, paths hold {int(leaf_depth.sum())}")
    log(f"[connect4] backprop vs plain on those paths: visits, value sums, root stats "
        f"and min/max equal; {changed} edges updated")

    # Timings at this snapshot (the main path's shapes): the device time of
    # a launch (graph replay), and the time of a call from Python (eager
    # launches back to back, which the host's wrapper cost can set). Backprop
    # repeats on a working copy: the same paths, so the same walk each time.
    def descend():
        return mcts_kernels.descend_planar(*dargs, **dkw)

    def backprop():
        return mcts_kernels.backprop(*bp_args(w_tree), **bkw)

    def backprop_floor():  # the same launch with nothing to back up
        return mcts_kernels.backprop(*bp_args(w_tree, no_leaf), **bkw)

    w_tree = mcts_ops.Tree(*(x.clone() for x in tree))
    no_leaf = torch.full_like(leaf_depth, -1)
    with torch.no_grad():
        d_call = cuda_ms(descend, 50)
        d_ms = statistics.median(graph_ms(descend, 50) for _ in range(5))
        mcts_kernels.descend_planar_plain(*dargs, **dkw)
        d_plain = cuda_ms(lambda: mcts_kernels.descend_planar_plain(*dargs, **dkw), 1)
        b_call = cuda_ms(backprop, 50)
        b_ms = statistics.median(graph_ms(backprop, 50) for _ in range(5))
        b_floor = statistics.median(graph_ms(backprop_floor, 50) for _ in range(5))
        b_plain = cuda_ms(lambda: mcts_kernels.backprop_plain(*bp_args(w_tree), **bkw), 1)
    d_bound, d_by = bound_ms(*descend_work(leaf_depth, int(depth_bound), B, A, D))
    b_bound, b_by = bound_ms(*backprop_work(leaf_depth, B))
    for name, ms, call, plain, bnd, by in (("descend_planar", d_ms, d_call, d_plain, d_bound,
                                            d_by),
                                           ("backprop", b_ms, b_call, b_plain, b_bound, b_by)):
        log(f"[connect4] {name} {ms:.4f} ms/launch on the card (median of 5 CUDA graphs of 50 "
            f"launches), {call:.4f} ms per call from Python (CUDA events, 50 calls), plain "
            f"{plain:.3f} ms, bound {bnd:.6f} ms ({by})")
    # The chain's cost per level: the deepest lane sets a launch's length.
    deepest = int(leaf_depth.max())
    per_level_us = 1e3 * d_ms / deepest
    b_per_level_us = 1e3 * b_ms / deepest
    log(f"[connect4] per level of the deepest lane (depth {deepest}): descend_planar "
        f"{per_level_us:.3f} us ({d_ms:.4f} ms), backprop {b_per_level_us:.3f} us "
        f"({b_ms:.4f} ms); backprop floor (every leaf depth -1, the same launch) "
        f"{b_floor:.4f} ms")
    return {
        "descend_planar": dict(ms=d_ms, call_ms=d_call, plain_ms=d_plain, bound_ms=d_bound,
                               bound_by=d_by, max_abs_err=d_err, per_level_us=per_level_us,
                               deepest=deepest),
        "backprop": dict(ms=b_ms, call_ms=b_call, plain_ms=b_plain, bound_ms=b_bound,
                         bound_by=b_by, max_abs_err=bp_err, per_level_us=b_per_level_us,
                         deepest=deepest, floor_ms=b_floor),
    }


def whole_search_check(driver, folded, game="connect4"):
    """Phases 4c, 4g and 8c: run_mcts on the kernel route vs the kernels'
    plain versions at the driver's mid-game roots, same noise and jitter
    seed. Returns the kernel route's MCTSOutput (its tree node-major) and
    the roots' legal mask."""
    from muzero_general_tpu_torch.ops import mcts as mcts_ops
    from muzero_general_tpu_torch.ops.stacking import stack_observations

    carry, spec, env = driver._carry, driver.spec, driver.env
    B, A = driver.G, driver.A
    gen = torch.Generator(device="cuda").manual_seed(21)
    stacked = stack_observations(carry.obs_hist, carry.act_hist, A)
    legal, to_play = env.legal_actions_mask(carry.env_state), env.to_play(carry.env_state)
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        with torch.no_grad():
            root = folded.initial_inference(stacked)
            noise = mcts_ops.sample_gamma(spec.dirichlet_alpha, (B, A), gen, stacked.device)
            outs, secs = [], []
            for plain in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(mcts_ops.run_mcts(
                    folded.initial_inference, folded.recurrent_inference, stacked, legal,
                    to_play, gen, spec, root_outputs=root, root_noise=noise, seed=777,
                    plain_kernels=plain))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
    finally:
        cudnn.benchmark, cudnn.deterministic = saved
    k, p = outs
    err = float((k.root_value - p.root_value).abs().max())
    if not torch.equal(k.root_visit_counts, p.root_visit_counts):
        fail("whole search: kernel and plain routes differ in root visits")
    if not torch.equal(k.max_tree_depth, p.max_tree_depth):
        fail("whole search: kernel and plain routes differ in depth")
    if not err <= VALUE_TOL:
        fail(f"whole search: root values differ by {err!r}")
    visits = k.root_visit_counts
    if not bool((visits.sum(1) == spec.num_simulations).all()):
        fail("whole search: root visits do not sum to the simulation count")
    if bool(visits[~legal].any()):
        fail("whole search: an illegal root action got visits")
    log(f"[{game}] whole search at the driver's {B} mid-game roots, {spec.num_simulations} "
        f"sims, kernels vs their plain versions (jitter seed 777): visits and depth equal, "
        f"max |d root value| {err!r}, max depth {int(k.max_tree_depth.max())}; "
        f"{secs[0] * 1e3:.1f} ms vs {secs[1] * 1e3:.1f} ms (host clock)")
    return k, legal


def profile_move(driver, move_ms, means=()):
    """One move under torch.profiler: the device time of its kernels, their
    launches per simulation, the card's busy share of an unprofiled move
    (`move_ms`, the profiler slows the host) and the largest kernels; for
    each name in `means`, the mean device time per launch of the kernels
    whose names hold it. Prints "not measured" when the trace holds no
    device time."""
    temps = torch.ones((driver.G,))
    rows, wall_ms, t_parse = device_trace(lambda: driver.play_chunk(temps, 1))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        log(f"[profile] one move: {wall_ms:.2f} ms wall (profiled); device time: not "
            "measured (the trace holds none)")
        return
    share = 100 * busy_ms / move_ms
    launches = sum(r[2] for r in rows)
    log(f"[profile] one move: {busy_ms:.2f} ms of device kernels ({len(rows)} kernel names, "
        f"{launches} launches, {launches / driver.spec.num_simulations:.1f} per simulation); "
        f"{wall_ms:.2f} ms wall profiled; of an "
        f"unprofiled move ({move_ms:.2f} ms) the card is busy {share:.1f}%, idle "
        f"{100 - share:.1f}%; trace read in {time.perf_counter() - t_parse:.1f} s")
    for dev_us, key, count in sorted(rows, reverse=True)[:10]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")
    for name in means:
        dev_us = sum(r[0] for r in rows if name in r[1])
        count = sum(r[2] for r in rows if name in r[1])
        if count:
            log(f"[profile] {name}: main-path mean {dev_us / 1e3 / count:.4f} ms per launch "
                f"({count} launches, {dev_us / 1e3:.3f} ms)")


def quality_gate(cfg, folded, env, gate=True):
    """Phases 4d and 4h: 64 games of MuZero (player 0, moves first,
    temperature 0 with root noise as evaluate.py) against the env's expert.
    gate: fail below QUALITY_WINS wins (else only recorded). Returns the
    number won."""
    from muzero_general_tpu_torch.ops import mcts as mcts_ops

    dev = torch.device("cuda")
    G = QUALITY_GAMES
    gen = torch.Generator(device=dev).manual_seed(31)
    spec = mcts_ops.SearchSpec.from_config(cfg, G, dev)
    state = env.reset(G, gen)
    wins = torch.zeros((G,), dtype=torch.bool, device=dev)
    losses = torch.zeros_like(wins)
    for _ in range(cfg.max_moves):
        if bool(state.done.all()):
            break
        muzero = env.to_play(state) == 0
        legal = env.legal_actions_mask(state)
        with torch.no_grad():
            out = mcts_ops.run_mcts(folded.initial_inference, folded.recurrent_inference,
                                    env.observation(state), legal, env.to_play(state), gen,
                                    spec, add_exploration_noise=True)
        greedy = torch.argmax(torch.where(legal, out.root_visit_counts, -1), dim=1)
        action = torch.where(muzero, greedy, env.expert_action(state, gen).long())
        state, reward, _ = env.step(state, action, gen)
        wins |= muzero & (reward > 0)
        losses |= ~muzero & (reward > 0)
    n_win, n_loss = int(wins.sum()), int(losses.sum())
    log(f"[connect4] quality: {G} games, pretrained MuZero (first, temperature 0, root "
        f"noise, {cfg.num_simulations} sims, {spec.batch_leaves} leaves per round) vs the "
        f"expert: {n_win} won, {n_loss} lost, {G - n_win - n_loss} drawn"
        + ("" if gate else " (recorded, not a gate)"))
    if gate and n_win < QUALITY_WINS:
        fail(f"quality gate: MuZero won {n_win} of {G} < {QUALITY_WINS}")
    return n_win


def design_fields(name, numbers):
    """The fields a tree kernel's entry of the kernels line adds: its design,
    its time per level of the deepest lane and (backprop) its floor, the
    same launch with nothing to back up."""
    design = BACKPROP_DESIGN if name.startswith("backprop") else DESCEND_DESIGN
    fields = {"design": design, "per_level_us": numbers["per_level_us"],
              "deepest": numbers["deepest"]}
    if "floor_ms" in numbers:
        fields["floor_ms"] = numbers["floor_ms"]
    return fields


def connect4_path():
    """Phases 4a-4d; returns the two kernels' entries of the kernels line,
    the end state of 4c, the replay buffer of 4b and 4b's launches of the
    fused 3x3 conv."""
    from muzero_general_tpu_torch.games.connect4 import MuZeroConfig, make_env
    from muzero_general_tpu_torch.models import MuZeroNetwork, fold_bn
    from muzero_general_tpu_torch.ops import conv3x3 as conv_op
    from muzero_general_tpu_torch.ops import mcts_kernels
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    cfg = MuZeroConfig()
    cfg.parallel_games = 256
    cfg.selfplay_chunk_moves = 8
    net = load_pretrained(MuZeroNetwork(cfg), C4_CHECKPOINT)
    folded = fold_bn(net)
    env = make_env()
    kernels = snapshot_checks(cfg, folded, env)

    # ---- 4b. the main path -----------------------------------------------
    driver = SelfPlayDriver(env, net, cfg, seed=0)
    if driver.use_fused or not driver.spec.use_kernels or not driver.fold_bn:
        fail("connect4: the driver did not route to the staged search's kernels")
    K, reps, S = cfg.selfplay_chunk_moves, 3, cfg.num_simulations
    mcts_kernels.descend_planar.launches = 0
    mcts_kernels.backprop.launches = 0
    conv_op.conv3x3.launches = 0
    games = []
    chunk_s, loop_ms, stats, _ = timed_play(driver, reps, games)
    launches = {"descend_planar": mcts_kernels.descend_planar.launches,
                "backprop": mcts_kernels.backprop.launches}
    moves = (reps + 1) * K
    for name, count in launches.items():
        if count != S * moves:
            fail(f"connect4 main path: {name} launched {count} times for {moves} moves "
                 f"x {S} sims")
    conv_launches = check_conv3x3_launches("connect4 main path", cfg, driver.G, 1, moves)
    log(f"[connect4] SelfPlayDriver.play: {driver.G} lanes x {S} sims, {K} moves/chunk, "
        f"pretrained 3x64 ResNet: {chunk_s * 1e3:.2f} ms/chunk, "
        f"{stats['env_steps'] / chunk_s:.1f} env-steps/s, launches {launches} = "
        f"{S} x {moves} moves, max tree depth {stats['max_tree_depth']}")
    move_ms = chunk_s * 1e3 / K

    # The device work of a move: S recurrent inferences and one initial one
    # at the driver's batch (device time by graph replay; per call from
    # Python by CUDA events), and S launches of each tree kernel.
    rec_ms, init_ms, rec_call = network_ms(folded, driver)
    dev_net = S * rec_ms + init_ms
    dev_kern = S * (kernels["descend_planar"]["ms"] + kernels["backprop"]["ms"])
    log(f"[connect4] per move: {move_ms:.3f} ms = move loop {loop_ms:.3f} + host episode "
        f"cuts {move_ms - loop_ms:.3f}. Device work in the loop: network {dev_net:.3f} "
        f"({S} x {rec_ms:.4f} recurrent + {init_ms:.4f} initial, graph replay; "
        f"{rec_call:.4f} ms per recurrent call from Python) + tree kernels {dev_kern:.3f} "
        f"({S} x (descend {kernels['descend_planar']['ms']:.4f} + backprop "
        f"{kernels['backprop']['ms']:.4f})); the other {loop_ms - dev_net - dev_kern:.3f} ms "
        f"is host time the card waits on and small ops")
    profile_move(driver, loop_ms)
    c4_replay = replay_phase("connect4 replay", MuZeroConfig(), games)

    # ---- 4c, 4d ----------------------------------------------------------
    end_state = (*whole_search_check(driver, folded), driver.spec)
    quality_gate(cfg, folded, make_env())

    entries = []
    for name, replaces in (("descend_planar", "muzero_general_tpu/ops/mcts_pallas.py:217"),
                           ("backprop", "muzero_general_tpu/ops/mcts_pallas.py:387")):
        entries.append(design_fields(name, kernels[name]) | {
            "name": name,
            "route": "cuda",
            "source": CSRC + "mcts_kernels.cu",
            "replaces": replaces,
            "launches": launches[name],
            "visits_exact": True,  # the checks failed the run otherwise
            "max_abs_err": kernels[name]["max_abs_err"],
            "ms": kernels[name]["ms"],
            "call_ms": kernels[name]["call_ms"],
            "plain_ms": kernels[name]["plain_ms"],
            "bound_ms": kernels[name]["bound_ms"],
            "bound_by": kernels[name]["bound_by"],
            "library_ms": None,  # no single PyTorch call descends or backs up a tree
        })
    return entries, end_state, c4_replay, conv_launches


# ---------------------------------------------------------------------------
# The connect4 path at 8 leaves per round: the marking descent and the
# pre-marked backprop
# ---------------------------------------------------------------------------


def check_equal_tensors(name, got, want, names):
    """Fail unless each pair is bit-equal; returns the largest |difference|."""
    err = 0.0
    for field, g, w in zip(names, got, want):
        err = max(err, float((g.double() - w.double()).abs().max()))
        if not torch.equal(g, w):
            bad = (g != w).reshape(g.shape[0], -1).any(1).nonzero()
            fail(f"{name}: kernel and plain differ in {field} at lane {int(bad[0])}")
    return err


def multileaf_snapshot_checks(cfg, folded, env):
    """Phase 4e: the marking descent and the pre-marked backprop vs their
    plain versions on a real 256-lane K = 8 tree after 96 of 200 simulations
    (12 whole rounds), over the next round's 8 selections. Returns
    per-kernel numbers."""
    from muzero_general_tpu_torch.ops import mcts as mcts_ops
    from muzero_general_tpu_torch.ops import mcts_kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(51)
    B, A, D = cfg.parallel_games, len(cfg.action_space), cfg.num_simulations + 1
    spec = mcts_ops.SearchSpec.from_config(cfg, B, dev)
    K = spec.batch_leaves
    if not spec.use_kernels or K != 8:
        fail("connect4 at 8 leaves per round did not take the kernel route")
    state = random_positions(env, B, 6, gen)
    obs, legal, to_play = env.observation(state), env.legal_actions_mask(state), env.to_play(state)
    sim, seed = 96, 5151
    with torch.no_grad():
        out = mcts_ops.run_mcts(folded.initial_inference, folded.recurrent_inference, obs,
                                legal, to_play, gen, spec, seed=seed, num_steps=sim)
    tree = mcts_ops._to_planar(out.tree)
    depth_bound = (out.max_tree_depth.max() + 1).to(torch.int32)
    legal_i32 = legal.to(torch.int32).contiguous()
    dkw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
               pb_c_init=spec.pb_c_init, discount=spec.discount,
               max_depth=spec.max_depth, tie_jitter=spec.tie_jitter, mark_visits=True)

    def dargs(t, k):
        return (seed, sim + k, depth_bound, t.children_index, t.children_prior,
                t.children_visit, t.children_vsum, t.children_reward, legal_i32,
                t.min_value, t.max_value)

    # The round's K selections, each on its own side's marked slab.
    k_tree = tree._replace(children_visit=tree.children_visit.clone())
    p_tree = tree._replace(children_visit=tree.children_visit.clone())
    names = ("parent", "action", "leaf_depth", "path_nodes", "path_actions", "marked visits")
    sels, d_err = [], 0.0
    for k in range(K):
        got = mcts_kernels.descend_planar(*dargs(k_tree, k), **dkw)
        want = mcts_kernels.descend_planar_plain(*dargs(p_tree, k), **dkw)
        torch.cuda.synchronize()
        d_err = max(d_err, check_equal_tensors(f"descend_planar (mark_visits), selection {k}",
                                               got + (k_tree.children_visit,),
                                               want + (p_tree.children_visit,), names))
        sels.append(got)
    leaf_depth = torch.stack([s[2] for s in sels])
    if bool((leaf_depth < 1).any()):
        fail("descend_planar (mark_visits): a lane was cut by the depth bound")
    marks = int((k_tree.children_visit - tree.children_visit).sum())
    if marks != int(leaf_depth.sum()):
        fail(f"descend_planar (mark_visits): {marks} marks, paths hold {int(leaf_depth.sum())}")
    distinct = int((torch.stack([s[4] for s in sels]) != sels[0][4]).any(2).any(0).sum())
    log(f"[connect4 K=8] descend_planar(mark_visits) vs plain over one round of {K} "
        f"selections at a {B}-lane tree after {sim} sims, tie jitter {spec.tie_jitter!r}: "
        f"all five outputs and the marked slab equal at every selection; {marks} marks; leaf "
        f"depths {int(leaf_depth.min())}-{int(leaf_depth.max())}; {distinct} lanes' later "
        f"selections left the first one's path")

    # The round's K pre-marked backprops, one after another, on both sides.
    marked = k_tree._replace(root_visit=k_tree.root_visit + K)
    values = torch.randn((K, B), generator=gen, device=dev) * 3
    bkw = dict(num_players=spec.num_players, discount=spec.discount, planar=True,
               pre_marked=True)

    def bp_args(t, k, depth=None):
        s = sels[k]
        return (s[3], s[4], s[2] if depth is None else depth, values[k], t.children_visit,
                t.children_vsum, t.children_reward, t.root_visit, t.root_vsum, t.root_reward,
                t.min_value, t.max_value)

    k_bp = mcts_ops.Tree(*(x.clone() for x in marked))
    p_bp = mcts_ops.Tree(*(x.clone() for x in marked))
    for k in range(K):
        k_out = mcts_kernels.backprop(*bp_args(k_bp, k), **bkw)
        p_out = mcts_kernels.backprop_plain(*bp_args(p_bp, k), **bkw)
    torch.cuda.synchronize()
    slabs = ("children_visit", "children_vsum", "root_visit", "root_vsum", "min_value",
             "max_value")
    b_err = check_equal_tensors("backprop (pre_marked)", k_out, p_out, slabs)
    if not (torch.equal(k_bp.children_visit, marked.children_visit)
            and torch.equal(k_bp.root_visit, marked.root_visit)):
        fail("backprop (pre_marked): visits changed")
    log(f"[connect4 K=8] backprop(pre_marked) vs plain on those {K} paths, folded one after "
        f"another: visits (unchanged), value sums, root stats and min/max equal")

    # Timings at this snapshot, on working copies: the marking descent of the
    # round's first selection (its marks pile up over the repeats) and the
    # first path's pre-marked backprop.
    w_tree = tree._replace(children_visit=tree.children_visit.clone())
    w_bp = mcts_ops.Tree(*(x.clone() for x in marked))

    def descend():
        return mcts_kernels.descend_planar(*dargs(w_tree, 0), **dkw)

    def backprop():
        return mcts_kernels.backprop(*bp_args(w_bp, 0), **bkw)

    def backprop_floor():  # the same launch with nothing to back up
        return mcts_kernels.backprop(*bp_args(w_bp, 0, no_leaf), **bkw)

    no_leaf = torch.full_like(sels[0][2], -1)
    with torch.no_grad():
        d_call = cuda_ms(descend, 50)
        d_ms = statistics.median(graph_ms(descend, 50) for _ in range(5))
        mcts_kernels.descend_planar_plain(*dargs(w_tree, 0), **dkw)
        d_plain = cuda_ms(lambda: mcts_kernels.descend_planar_plain(*dargs(w_tree, 0), **dkw),
                          1)
        b_call = cuda_ms(backprop, 50)
        b_ms = statistics.median(graph_ms(backprop, 50) for _ in range(5))
        b_floor = statistics.median(graph_ms(backprop_floor, 50) for _ in range(5))
        b_plain = cuda_ms(lambda: mcts_kernels.backprop_plain(*bp_args(w_bp, 0), **bkw), 1)
    d_bound, d_by = bound_ms(*descend_work(sels[0][2], int(depth_bound), B, A, D, marked=True))
    b_bound, b_by = bound_ms(*backprop_work(sels[0][2], B, pre_marked=True))
    for name, ms, call, plain, bnd, by in (("descend_planar (mark_visits)", d_ms, d_call,
                                            d_plain, d_bound, d_by),
                                           ("backprop (pre_marked)", b_ms, b_call, b_plain,
                                            b_bound, b_by)):
        log(f"[connect4 K=8] {name} {ms:.4f} ms/launch on the card (median of 5 CUDA graphs "
            f"of 50 launches), {call:.4f} ms per call from Python (CUDA events, 50 calls), "
            f"plain {plain:.3f} ms, bound {bnd:.6f} ms ({by})")
    deepest = int(sels[0][2].max())
    per_level_us = 1e3 * d_ms / deepest
    b_per_level_us = 1e3 * b_ms / deepest
    log(f"[connect4 K=8] per level of the deepest lane (depth {deepest}, the round's first "
        f"selection): descend_planar (mark_visits) {per_level_us:.3f} us ({d_ms:.4f} ms), "
        f"backprop (pre_marked) {b_per_level_us:.3f} us ({b_ms:.4f} ms); backprop floor "
        f"(every leaf depth -1, the same launch) {b_floor:.4f} ms")
    return {
        "descend_planar_mark": dict(ms=d_ms, call_ms=d_call, plain_ms=d_plain,
                                    bound_ms=d_bound, bound_by=d_by, max_abs_err=d_err,
                                    per_level_us=per_level_us, deepest=deepest),
        "backprop_pre_marked": dict(ms=b_ms, call_ms=b_call, plain_ms=b_plain,
                                    bound_ms=b_bound, bound_by=b_by, max_abs_err=b_err,
                                    per_level_us=b_per_level_us, deepest=deepest,
                                    floor_ms=b_floor),
    }


def connect4_multileaf_path():
    """Phases 4e-4h; returns the marking descent's and the pre-marked
    backprop's entries of the kernels line and 4f's launches of the fused
    3x3 conv."""
    from muzero_general_tpu_torch.games.connect4 import MuZeroConfig, make_env
    from muzero_general_tpu_torch.models import MuZeroNetwork, fold_bn
    from muzero_general_tpu_torch.models.resnet import ResMuZero
    from muzero_general_tpu_torch.ops import conv3x3 as conv_op
    from muzero_general_tpu_torch.ops import mcts_kernels
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    cfg = MuZeroConfig()
    cfg.parallel_games = 256
    cfg.selfplay_chunk_moves = 8
    cfg.search_batch_leaves = 8
    net = load_pretrained(MuZeroNetwork(cfg), C4_CHECKPOINT)
    folded = fold_bn(net)
    env = make_env()
    kernels = multileaf_snapshot_checks(cfg, folded, env)

    # ---- 4f. the main path -------------------------------------------------
    driver = SelfPlayDriver(env, net, cfg, seed=0)
    spec = driver.spec
    if driver.use_fused or not spec.use_kernels or spec.batch_leaves != 8 or not driver.fold_bn:
        fail("connect4 K=8: the driver did not route to the marking kernels")
    # one timed chunk (3 before phase 18)
    K, reps, S, L = cfg.selfplay_chunk_moves, 1, cfg.num_simulations, spec.batch_leaves
    inferences = []
    recurrent_inference = ResMuZero.recurrent_inference

    def counted_recurrent_inference(self, hidden, action):
        inferences.append(hidden.shape[0])
        return recurrent_inference(self, hidden, action)

    ResMuZero.recurrent_inference = counted_recurrent_inference
    try:
        d, b = mcts_kernels.descend_planar, mcts_kernels.backprop
        d.launches = d.marked_launches = b.launches = b.pre_marked_launches = 0
        conv_op.conv3x3.launches = 0
        chunk_s, loop_ms, stats, records = timed_play(driver, reps)
        launches = {"descend_planar_mark": d.marked_launches,
                    "backprop_pre_marked": b.pre_marked_launches,
                    "descend_planar": d.launches - d.marked_launches,
                    "backprop": b.launches - b.pre_marked_launches}
    finally:
        ResMuZero.recurrent_inference = recurrent_inference
    moves = (reps + 1) * K
    for name in ("descend_planar_mark", "backprop_pre_marked"):
        if launches[name] != S * moves:
            fail(f"connect4 K=8 main path: {name} launched {launches[name]} times for "
                 f"{moves} moves x {S} sims")
    if launches["descend_planar"] or launches["backprop"]:
        fail(f"connect4 K=8 main path: unmarked tree kernels launched: {launches}")
    conv_launches = check_conv3x3_launches("connect4 K=8 main path", cfg, driver.G, L, moves)
    if len(inferences) != moves * S // L or set(inferences) != {L * driver.G}:
        fail(f"connect4 K=8 main path: {len(inferences)} recurrent inferences of batch "
             f"{sorted(set(inferences))} for {moves} moves x {S // L} rounds of {L * driver.G}")
    for rec in records:
        full = rec.observation[:, :, :2, -1, :].sum(2) > 0  # [K, G, columns]
        policy = rec.child_visits
        if not bool(((policy.sum(-1) - 1).abs() < 1e-5).all()):
            fail("connect4 K=8 main path: a visit policy does not sum to 1")
        if bool((policy[full] != 0).any()):
            fail("connect4 K=8 main path: a full column got visits")
    log(f"[connect4 K=8] SelfPlayDriver.play: {driver.G} lanes x {S} sims in {S // L} rounds "
        f"of {L} leaves, {K} moves/chunk, pretrained 3x64 ResNet: {chunk_s * 1e3:.2f} "
        f"ms/chunk, {stats['env_steps'] / chunk_s:.1f} env-steps/s, launches {launches} "
        f"({S} per move), {len(inferences) // moves} recurrent inferences of "
        f"{L * driver.G} leaves per move, max tree depth {stats['max_tree_depth']}")
    move_ms = chunk_s * 1e3 / K
    rec_ms, init_ms, rec_call = network_ms(folded, driver, leaves=L, reps=10)
    dev_net = S // L * rec_ms + init_ms
    dev_kern = S * (kernels["descend_planar_mark"]["ms"] + kernels["backprop_pre_marked"]["ms"])
    log(f"[connect4 K=8] per move: {move_ms:.3f} ms = move loop {loop_ms:.3f} + host episode "
        f"cuts {move_ms - loop_ms:.3f}. Device work in the loop: network {dev_net:.3f} "
        f"({S // L} x {rec_ms:.4f} recurrent at {L * driver.G} leaves + {init_ms:.4f} initial, "
        f"graph replay; {rec_call:.4f} ms per recurrent call from Python) + tree kernels "
        f"{dev_kern:.3f} ({S} x (descend {kernels['descend_planar_mark']['ms']:.4f} + backprop "
        f"{kernels['backprop_pre_marked']['ms']:.4f})); the other "
        f"{loop_ms - dev_net - dev_kern:.3f} ms is host time the card waits on and small ops")
    profile_move(driver, loop_ms)

    # ---- 4g, 4h -------------------------------------------------------------
    whole_search_check(driver, folded, "connect4 K=8")
    wins = quality_gate(cfg, folded, make_env(), gate=False)

    entries = []
    for name, replaces in (("descend_planar_mark", "muzero_general_tpu/ops/mcts_pallas.py:217"),
                           ("backprop_pre_marked", "muzero_general_tpu/ops/mcts_pallas.py:387")):
        entries.append(design_fields(name, kernels[name]) | {
            "name": name,
            "route": "cuda",
            "source": CSRC + "mcts_kernels.cu",
            "replaces": replaces,
            "launches": launches[name],
            "visits_exact": True,  # the checks failed the run otherwise
            "max_abs_err": kernels[name]["max_abs_err"],
            "ms": kernels[name]["ms"],
            "call_ms": kernels[name]["call_ms"],
            "plain_ms": kernels[name]["plain_ms"],
            "bound_ms": kernels[name]["bound_ms"],
            "bound_by": kernels[name]["bound_by"],
            "library_ms": None,  # no single PyTorch call descends or backs up a tree
        })
    entries[0]["quality_wins_of_64"] = wins  # recorded, not a gate
    return entries, conv_launches


# ---------------------------------------------------------------------------
# Kernel 11: the folded ResNet's fused float32 3x3 conv
# ---------------------------------------------------------------------------

CONV3X3_DESIGN = ("implicit GEMM on the CUDA cores, float32 FMA: a thread 8 samples x 8 output "
                  "channels at one position, a block 8 samples x all rows x 32 channels; "
                  "activations staged sample-innermost with an in-kernel zero halo, weights "
                  "and activations through a cp.async double buffer of 8-channel chunks, the "
                  "skip tile by cp.async with the last chunk; bias, skip and ReLU in the "
                  "epilogue; persistent grid")


def conv3x3_launches_a_move(cfg, lanes, leaves=1):
    """The fused 3x3 conv's launches in one move of a folded float32 ResNet
    without a downsampler at `lanes` lanes and `leaves` leaves a round, as
    ops/conv3x3.py's rule routes its convs: the initial inference's
    representation conv and two towers of blocks (the representation's and
    the prediction's), then each round's dynamics conv (the action plane
    one more channel) and two towers (the dynamics' and the prediction's)."""
    from muzero_general_tpu_torch.ops import conv3x3 as conv_op
    from muzero_general_tpu_torch.tools.profiling import stacked_shape

    f32 = torch.float32
    c, (h, w) = cfg.channels, cfg.observation_shape[1:]

    def takes(n, cin):
        return int(conv_op.takes_kernel(f32, f32, f32, (3, 3), (1, 1), (1, 1), None,
                                        (n, cin, c, h, w)))

    tower = 2 * 2 * cfg.blocks  # two convs a block
    initial = takes(lanes, stacked_shape(cfg)[0]) + tower * takes(lanes, c)
    recurrent = takes(lanes * leaves, c + 1) + tower * takes(lanes * leaves, c)
    return initial + cfg.num_simulations // leaves * recurrent


def check_conv3x3_launches(label, cfg, lanes, leaves, moves):
    """Fail unless the fused 3x3 conv, counted from zero before `moves`
    moves, launched once for every conv the routing rule sends to it.
    Returns the launches."""
    from muzero_general_tpu_torch.ops import conv3x3 as conv_op

    got, a_move = conv_op.conv3x3.launches, conv3x3_launches_a_move(cfg, lanes, leaves)
    if got != a_move * moves:
        fail(f"{label}: the fused 3x3 conv launched {got} times for {moves} moves, want "
             f"{a_move} a move")
    log(f"[{label}] the fused 3x3 conv: {got} launches = {a_move} a move x {moves} moves")
    return got


def conv3x3_phase(k8_launches, k1_launches):
    """Phase 4i, kernel 11: the fused conv against conv3x3_plain on the same
    seeded inputs at the connect4 cells' batches and channel counts, with
    and without the skip. Both are float32 sums of k = 9 Cin + 2 terms in
    different orders, each within gamma_k sum |term| of the exact value, so
    they may differ by twice that, elementwise; the kernel is also held to
    gamma_k sum |term| of a float64 conv. Each timed as 20 chained calls in
    one CUDA graph; bound_ms from the shape's FLOPs and bytes (input,
    weights, bias, skip, output). Returns the kernel's entry of the kernels
    line, with 4f's launches (the K = 8 main path at 2,048 leaves) and
    4b's."""
    import torch.nn.functional as F

    from muzero_general_tpu_torch.models.common import FullPrecision
    from muzero_general_tpu_torch.ops import conv3x3 as conv_op

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(411)
    u = 2.0 ** -24
    cases = []
    for n in (1024, 2048):
        for cin in (3, 64, 65):
            bound_w = (9 * cin) ** -0.5
            x = torch.randn((n, cin, 6, 7), generator=gen, device=dev)
            wt = (torch.rand((64, cin, 3, 3), generator=gen, device=dev) * 2 - 1) * bound_w
            b = (torch.rand((64,), generator=gen, device=dev) * 2 - 1) * bound_w
            packed = conv_op.pack_weight(wt)
            terms0 = (F.conv2d(x.double().abs(), wt.double().abs(), None, 1, 1)
                      + b.double().abs()[:, None, None])
            exact0 = F.conv2d(x.double(), wt.double(), b.double(), 1, 1)
            for with_skip in (False, True):
                skip = torch.randn((n, 64, 6, 7), generator=gen, device=dev) if with_skip else None
                terms = terms0 if skip is None else terms0 + skip.double().abs()
                exact = torch.relu(exact0 if skip is None else exact0 + skip.double())
                k = 9 * cin + 2
                gamma = k * u / (1 - k * u)
                with torch.no_grad(), FullPrecision():
                    got = conv_op.conv3x3(x, wt, b, skip, packed)
                    want = conv_op.conv3x3_plain(x, wt, b, skip)
                    torch.cuda.synchronize()
                    d_plain = (got.double() - want.double()).abs()
                    d_exact = (got.double() - exact).abs()
                    if not bool((d_plain <= 2 * gamma * terms).all()):
                        fail(f"conv3x3 [{n}, {cin} -> 64, 6, 7] skip={with_skip}: kernel and "
                             f"plain differ by {float(d_plain.max())!r}, beyond the float32 "
                             f"sums' bound")
                    if not bool((d_exact <= gamma * terms).all()):
                        fail(f"conv3x3 [{n}, {cin} -> 64, 6, 7] skip={with_skip}: the kernel "
                             f"is {float(d_exact.max())!r} off a float64 conv, beyond gamma_k "
                             f"sum |term|")
                    ms = graph_ms(lambda: conv_op.conv3x3(x, wt, b, skip, packed), 20)
                    plain_ms = graph_ms(lambda: conv_op.conv3x3_plain(x, wt, b, skip), 20)
                flops = 2 * n * 6 * 7 * 9 * cin * 64
                nbytes = 4 * (x.numel() + wt.numel() + b.numel() + n * 64 * 42
                              * (2 if with_skip else 1))
                bnd, by = bound_ms(flops, nbytes)
                row = {"shape": [n, cin, 64, 6, 7], "skip": with_skip,
                       "max_abs_err": float(d_plain.max()),
                       "max_abs_err_f64": float(d_exact.max()), "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bnd, "bound_by": by}
                cases.append(row)
                log(f"[conv3x3] [{n}, {cin} -> 64, 6, 7] skip={with_skip}: kernel vs plain max "
                    f"|d| {row['max_abs_err']!r}, vs float64 {row['max_abs_err_f64']!r} (within "
                    f"the float32 sums' bound); {ms:.4f} ms a conv (CUDA graph of 20), plain "
                    f"{plain_ms:.4f} ms; bound {bnd:.4f} ms ({by}), the kernel at "
                    f"{100 * bnd / ms:.1f}% of it, plain at {100 * bnd / plain_ms:.1f}%")
    main = next(c for c in cases if c["shape"] == [2048, 64, 64, 6, 7] and c["skip"])
    return {
        "name": "conv3x3",
        "route": "cuda",
        "source": CSRC + "conv3x3.cu",
        "replaces": None,  # the JAX package leaves its convolutions to XLA
        "design": CONV3X3_DESIGN,
        "launches": k8_launches,  # 4f, the K = 8 main path
        "connect4_k1_selfplay_launches": k1_launches,  # 4b, at 256 lanes
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main["ms"],  # [2,048, 64 -> 64, 6, 7] with the skip, a tower's second conv
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["plain_ms"],  # the plain version is the library's conv (cuDNN)
        "cases": cases,
    }


# ---------------------------------------------------------------------------
# Kernels 6 and 7: the node-major descent and the hidden-store row write,
# driven as the JAX package's tools drive theirs
# ---------------------------------------------------------------------------


def node_major_descend_phase(out, legal, spec):
    """Phase 6, the counterpart of tools/resnet_profile.py section 4b: the
    node-major descent on the realistic end-state tree of the connect4
    whole search (node-major, as run_mcts returns it). Kernel vs plain with
    tie jitter on, and vs the planar kernel on the same tree transposed;
    then the timing loop, which is this phase's path: its launches are
    counted."""
    from muzero_general_tpu_torch.ops import mcts as mcts_ops
    from muzero_general_tpu_torch.ops import mcts_kernels

    tree = out.tree
    B, N, A = tree.children_index.shape
    D = spec.max_depth + 1
    depth_bound = (out.max_tree_depth.max() + 1).to(torch.int32)
    legal_i32 = legal.to(torch.int32).contiguous()
    planar = mcts_ops._to_planar(tree)
    kw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
              pb_c_init=spec.pb_c_init, discount=spec.discount, max_depth=spec.max_depth,
              tie_jitter=spec.tie_jitter)

    def args(t):
        return (7, spec.num_simulations, depth_bound, t.children_index, t.children_prior,
                t.children_visit, t.children_vsum, t.children_reward, legal_i32,
                t.min_value, t.max_value)

    names = ("parent", "action", "leaf_depth", "path_nodes", "path_actions")
    got = mcts_kernels.descend(*args(tree), **kw)
    want = mcts_kernels.descend_plain(*args(tree), **kw)
    p_got = mcts_kernels.descend_planar(*args(planar), **kw)
    torch.cuda.synchronize()
    err = check_equal_tensors("descend (node-major)", got, want, names)
    check_equal_tensors("descend (node-major) vs descend_planar", got, p_got, names)
    leaf_depth = got[2]
    if bool((leaf_depth < 1).any()):
        fail("descend (node-major): a lane was cut by the depth bound")
    log(f"[descend] node-major kernel vs plain, and vs the planar kernel on the same end-state "
        f"tree ({B} lanes, {spec.num_simulations} sims, tie jitter {spec.tie_jitter!r}): all "
        f"five outputs equal; leaf depths {int(leaf_depth.min())}-{int(leaf_depth.max())}, "
        f"depth bound {int(depth_bound)}")

    with torch.no_grad():
        mcts_kernels.descend.launches = 0
        n_call = cuda_ms(lambda: mcts_kernels.descend(*args(tree), **kw), 50)
        launches = mcts_kernels.descend.launches
        n_ms = graph_ms(lambda: mcts_kernels.descend(*args(tree), **kw), 50)
        p_call = cuda_ms(lambda: mcts_kernels.descend_planar(*args(planar), **kw), 50)
        p_ms = graph_ms(lambda: mcts_kernels.descend_planar(*args(planar), **kw), 50)
        mcts_kernels.descend_plain(*args(tree), **kw)
        n_plain = cuda_ms(lambda: mcts_kernels.descend_plain(*args(tree), **kw), 1)
    if launches != 50:
        fail(f"descend (node-major): {launches} launches in the 50-call timing loop")
    bnd, by = bound_ms(*descend_work(leaf_depth, int(depth_bound), B, A, D))
    log(f"[descend] end-state tree: node-major {n_ms:.4f} ms/launch on the card (CUDA graph of "
        f"50), {n_call:.4f} ms per call (CUDA events, 50 calls); planar {p_ms:.4f} ms/launch, "
        f"{p_call:.4f} ms per call; plain {n_plain:.3f} ms; bound {bnd:.6f} ms ({by})")
    return {
        "name": "descend",
        "route": "cuda",
        "source": CSRC + "mcts_kernels.cu",
        "replaces": "muzero_general_tpu/ops/mcts_pallas.py:51",
        "design": DESCEND_DESIGN + " (the planar kernel's body on node-major slabs)",
        "launches": launches,  # the timing loop, this phase's path
        "visits_exact": True,
        "max_abs_err": err,
        "ms": n_ms,
        "call_ms": n_call,
        "planar_ms": p_ms,  # descend_planar on the same tree, same graph replay
        "plain_ms": n_plain,
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call descends a tree
    }


def row_write_phase():
    """Phase 7, the counterpart of tools/hidden_store_bench.py at its shape
    (N, B, F = 201, 256, 2688: connect4's 64 x 6 x 7 hidden state): kernel
    vs plain, bit-equal, every other row unchanged; then the bench's loop of
    200 simulations (gather row `parent`, write row i + 1), this phase's
    path, whose launches are counted, beside the same loop with an indexed
    PyTorch write; then one write's time beside store[node].copy_(leaf), in
    turns."""
    from muzero_general_tpu_torch.ops import hidden_store

    dev = torch.device("cuda")
    N, B, F, sims = 201, 256, 2688, 200
    gen = torch.Generator(device=dev).manual_seed(61)
    store = torch.randn((N, B, F), generator=gen, device=dev)
    leaf = torch.randn((B, F), generator=gen, device=dev)
    nodes = torch.arange(N, dtype=torch.int32, device=dev)
    got = hidden_store.write_node_hidden(store.clone(), nodes[7], leaf)
    want = hidden_store.write_node_hidden_plain(store.clone(), nodes[7], leaf)
    torch.cuda.synchronize()
    err = check_equal_tensors("write_node_hidden", (got,), (want,), ("store",))
    others = torch.arange(N, device=dev) != 7
    if not torch.equal(got[others], store[others]) or not torch.equal(got[7], leaf):
        fail("write_node_hidden: the write touched another row or missed its own")
    log(f"[hidden store] write_node_hidden vs plain at [{N}, {B}, {F}]: equal, the other "
        f"{N - 1} rows unchanged")

    b_idx = torch.arange(B, device=dev)
    parent = torch.zeros((B,), dtype=torch.long, device=dev)

    def loop(write):
        for i in range(sims):
            h = store[parent, b_idx]
            write(i + 1, h * 1.000001)

    def kernel(i, h):
        hidden_store.write_node_hidden(store, nodes[i], h)

    loop(kernel)  # warm-up
    hidden_store.write_node_hidden.launches = 0
    loop_kernel = cuda_ms(lambda: loop(kernel), 1) / sims
    launches = hidden_store.write_node_hidden.launches
    if launches != sims:
        fail(f"write_node_hidden: {launches} launches in the {sims}-simulation loop")

    def indexed(i, h):
        store[i] = h

    loop(indexed)
    loop_indexed = cuda_ms(lambda: loop(indexed), 1) / sims
    def write():
        hidden_store.write_node_hidden(store, nodes[7], leaf)

    # One write on the card (CUDA graph of 50): the kernel and
    # store[node].copy_(leaf) in turns (k, c, c, k), three times; each the
    # median of its six.
    times = {"kernel": [], "copy_": []}
    with torch.no_grad():
        for order in (("kernel", "copy_"), ("copy_", "kernel")) * 3:
            for name in order:
                if name == "kernel":
                    times[name].append(graph_ms(write, 50))
                else:
                    times[name].append(graph_ms(lambda: store[7].copy_(leaf), 50))
        call = cuda_ms(write, 50)
        plain = cuda_ms(lambda: hidden_store.write_node_hidden_plain(store, nodes[7], leaf), 20)
    ms, library = (statistics.median(times[k]) for k in ("kernel", "copy_"))
    bnd, by = bound_ms(0, 2 * B * F * 4)
    log(f"[hidden store] the bench's loop: {loop_kernel:.4f} ms per simulation with the "
        f"kernel, {loop_indexed:.4f} with store[i + 1] = h (CUDA events over {sims}); one "
        f"write {ms:.4f} ms on the card (CUDA graph of 50, median of 6 in turns: "
        f"{times['kernel']}), {call:.4f} ms per call, plain {plain:.4f} ms, "
        f"store[node].copy_(leaf) {library:.4f} ms ({times['copy_']}); bound {bnd:.6f} ms ({by}: "
        f"{2 * B * F * 4 / 1e6:.3f} MB)")
    log(f"[hidden store] write_node_hidden at {100 * bnd / ms:.1f}% of the bound, "
        f"{ms / library:.3f}x copy_'s time")
    return {
        "name": "write_node_hidden",
        "route": "cuda",
        "source": CSRC + "hidden_store.cu",
        "replaces": "muzero_general_tpu/ops/hidden_store.py:30",
        "design": "one wave of 256-thread blocks, two per SM, each an even contiguous share "
                  "of the row; up to 4 words in flight per thread, the leaf loads issued "
                  "before the read of node (one memory latency before the stores); word "
                  "16/4/2/1 bytes by alignment",
        "launches": launches,  # the bench loop, this phase's path
        "max_abs_err": err,
        "ms": ms,
        "call_ms": call,
        "plain_ms": plain,
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": library,
    }


# ---------------------------------------------------------------------------
# The gomoku path: the ResNet through the streaming search's two kernels
# ---------------------------------------------------------------------------


def stream_descend_work(lane_levels, B, A, D):
    """(FLOPs, bytes) one stream descent needs for this data: per level a
    lane descends (lane_levels in all), the four scored planes of its row
    over the A real columns and the chosen edge's child, and about 12
    operations per column plus a log, a sqrt and a few for the node; the
    root's legal row, the min/max and the bound once, and every output once
    ([B] x 3, [D, B] x 5)."""
    flops = lane_levels * (12 * A + 8)
    nbytes = lane_levels * 4 * (4 * A + 1) + 4 * (B * A + 2 * B + 1) + 4 * (3 * B + 5 * D * B)
    return flops, nbytes


def update_work(upd_depth, bound, B):
    """(FLOPs, bytes) one edge update needs for this data: the bound, each
    lane's mask below it, and per live (lane, level) its node, action and
    delta read and two floats read, added to and written back."""
    live = int(upd_depth.clamp(min=0).sum())
    return 2 * live, 4 + 4 * bound * B + live * (3 * 4 + 4 * 4)


def stream_snapshot_checks(cfg, folded, env):
    """Phase 8a: each stream kernel vs its plain version on a real 64-lane
    slab after 200 of 400 simulations. Returns per-kernel numbers."""
    from muzero_general_tpu_torch.ops import mcts as mcts_ops
    from muzero_general_tpu_torch.ops import mcts_stream

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    B, A, D = cfg.parallel_games, len(cfg.action_space), cfg.num_simulations + 1
    spec = mcts_ops.SearchSpec.from_config(cfg, B, dev)
    if not spec.use_stream:
        fail("gomoku at 64 lanes did not take the stream route")
    state = random_positions(env, B, 10, gen)
    obs, legal, to_play = env.observation(state), env.legal_actions_mask(state), env.to_play(state)
    sim, seed = cfg.num_simulations // 2, 4242
    with torch.no_grad():
        out = mcts_ops.run_mcts(folded.initial_inference, folded.recurrent_inference, obs,
                                legal, to_play, gen, spec, seed=seed, num_steps=sim)
    tree = out.tree
    edges = mcts_stream.pack_tree(tree, A)
    depth_bound = (out.max_tree_depth.max() + 1).to(torch.int32)
    legal_i32 = legal.to(torch.int32).contiguous()
    dargs = (seed, sim, depth_bound, edges, legal_i32, tree.min_value, tree.max_value)
    dkw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
               pb_c_init=spec.pb_c_init, discount=spec.discount, A=A,
               max_depth=spec.max_depth, tie_jitter=spec.tie_jitter)
    got = mcts_stream.descend_stream(*dargs, **dkw)
    want = mcts_stream.descend_stream_plain(*dargs, **dkw)
    torch.cuda.synchronize()
    names = ("parent", "action", "leaf_depth", "path_n", "path_a", "path_reward",
             "path_visit", "path_vsum")
    d_err = 0.0
    for name, g, w in zip(names, [*got[:5], *got[5]], [*want[:5], *want[5]]):
        d_err = max(d_err, float((g.double() - w.double()).abs().max()))
        if not torch.equal(g, w):
            bad = (g != w).reshape(-1, B).any(0).nonzero()
            fail(f"descend_stream: kernel and plain differ in {name} at lane {int(bad[0])}")
    leaf_depth = got[2]
    if bool((leaf_depth < 1).any()):
        fail("descend_stream: a lane was cut by the depth bound")
    lane_levels = int(leaf_depth.sum())  # a lane descends one level per unit of leaf depth
    log(f"[gomoku] descend_stream vs plain at a {B}-lane slab after {sim} sims, tie jitter "
        f"{spec.tie_jitter!r}: all eight outputs equal (max |d| {d_err!r}); leaf depths "
        f"{int(leaf_depth.min())}-{int(leaf_depth.max())}, depth bound {int(depth_bound)}, "
        f"{lane_levels} lane-levels")

    # The update on this descent's paths, as backprop_stream hands them over,
    # with every 8th lane cut to a depth-1 leaf under the deepest lane's bound.
    upd_depth = leaf_depth.clone()
    upd_depth[::8] = 1
    t_idx = torch.arange(D, device=dev)[:, None]
    mask = t_idx < upd_depth[None, :].long()
    delta = torch.randn((D, B), generator=gen, device=dev) * mask
    pn = torch.where(mask, got[3], edges.shape[1] - 1)
    pa = torch.where(mask, got[4], 0)
    mask = mask.to(torch.float32)
    bound = torch.amax(upd_depth)
    k_edges = mcts_stream.update_edges(edges.clone(), pn, pa, delta, mask, bound)
    p_edges = mcts_stream.update_edges_plain(edges.clone(), pn, pa, delta, mask, bound)
    torch.cuda.synchronize()
    live = slice(0, edges.shape[1] - 1)
    u_err = float((k_edges[:, live] - p_edges[:, live]).abs().max())
    if not torch.equal(k_edges[:, live], p_edges[:, live]):
        fail(f"update_edges: kernel and plain differ on live rows (max |d| {u_err!r})")
    added = int((k_edges[:, live, 0] - edges[:, live, 0]).sum())
    if added != int(upd_depth.sum()):
        fail(f"update_edges: {added} visits added, live levels {int(upd_depth.sum())}")
    log(f"[gomoku] update_edges vs plain on those paths ({int((upd_depth == 1).sum())} "
        f"depth-1 lanes under bound {int(bound)}): live rows equal (max |d| {u_err!r}); "
        f"{added} edge visits added")

    def descend():
        return mcts_stream.descend_stream(*dargs, **dkw)

    w_edges = edges.clone()
    no_level = torch.zeros_like(bound)

    def update():
        return mcts_stream.update_edges(w_edges, pn, pa, delta, mask, bound)

    def update_floor():  # the same launch with nothing to update
        return mcts_stream.update_edges(w_edges, pn, pa, delta, mask, no_level)

    with torch.no_grad():
        d_call = cuda_ms(descend, 50)
        d_ms = statistics.median(graph_ms(descend, 50) for _ in range(5))
        mcts_stream.descend_stream_plain(*dargs, **dkw)
        d_plain = cuda_ms(lambda: mcts_stream.descend_stream_plain(*dargs, **dkw), 1)
        u_call = cuda_ms(update, 50)
        u_ms = statistics.median(graph_ms(update, 50) for _ in range(5))
        u_floor = statistics.median(graph_ms(update_floor, 50) for _ in range(5))
        u_plain = cuda_ms(
            lambda: mcts_stream.update_edges_plain(w_edges, pn, pa, delta, mask, bound), 1)
    d_bound, d_by = bound_ms(*stream_descend_work(lane_levels, B, A, D))
    u_bound, u_by = bound_ms(*update_work(upd_depth, int(bound), B))
    for name, ms, call, plain, bnd, by in (("descend_stream", d_ms, d_call, d_plain, d_bound,
                                            d_by),
                                           ("update_edges", u_ms, u_call, u_plain, u_bound,
                                            u_by)):
        log(f"[gomoku] {name} {ms:.4f} ms/launch on the card (median of 5 CUDA graphs of 50 "
            f"launches), {call:.4f} ms per call from Python (CUDA events, 50 calls), plain "
            f"{plain:.3f} ms, bound {bnd:.6f} ms ({by})")
    log(f"[gomoku] update_edges floor (bound 0, the same launch): {u_floor:.4f} ms")
    # The chain's cost per level: the deepest lane sets a launch's length.
    deepest = int(leaf_depth.max())
    per_level_us = 1e3 * d_ms / deepest
    log(f"[gomoku] descend_stream per level of its deepest lane (depth {deepest}): "
        f"{per_level_us:.3f} us ({d_ms:.4f} ms); the bare row fetch's per level (kernel 10) "
        f"follows in phase 10")
    return {
        "descend_stream": dict(ms=d_ms, call_ms=d_call, plain_ms=d_plain, bound_ms=d_bound,
                               bound_by=d_by, max_abs_err=d_err, per_level_us=per_level_us,
                               deepest=deepest),
        "update_edges": dict(ms=u_ms, call_ms=u_call, plain_ms=u_plain, bound_ms=u_bound,
                             bound_by=u_by, max_abs_err=u_err, floor_ms=u_floor),
    }


def gomoku_path():
    """Phases 8a-8c; returns the two stream kernels' entries of the kernels
    line."""
    from muzero_general_tpu_torch.games.gomoku import MuZeroConfig, make_env
    from muzero_general_tpu_torch.models import MuZeroNetwork, fold_bn
    from muzero_general_tpu_torch.ops import mcts_stream
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    t_path = time.perf_counter()
    cfg = MuZeroConfig()
    cfg.parallel_games = 64
    cfg.selfplay_chunk_moves = 2
    net = MuZeroNetwork(cfg, seed=0)  # no gomoku checkpoint ships: seeded random init
    folded = fold_bn(net)
    env = make_env()
    kernels = stream_snapshot_checks(cfg, folded, env)
    log(f"[gomoku] snapshot checks done after {time.perf_counter() - t_path:.1f} s")

    # ---- 8b. the main path -----------------------------------------------
    driver = SelfPlayDriver(env, net, cfg, seed=0)
    spec = driver.spec
    if driver.use_fused or spec.use_kernels or not spec.use_stream or not driver.fold_bn:
        fail("gomoku: the driver did not route to the stream kernels with the BN folded")
    K, reps, S = cfg.selfplay_chunk_moves, 1, cfg.num_simulations  # 2 before phase 18
    mcts_stream.descend_stream.launches = 0
    mcts_stream.update_edges.launches = 0
    chunk_s, loop_ms, stats, records = timed_play(driver, reps)
    launches = {"descend_stream": mcts_stream.descend_stream.launches,
                "update_edges": mcts_stream.update_edges.launches}
    moves = (reps + 1) * K
    for name, count in launches.items():
        if count != S * moves:
            fail(f"gomoku main path: {name} launched {count} times for {moves} moves "
                 f"x {S} sims")
    for rec in records:
        occupied = rec.observation[:, :, :2].sum(2).reshape(K, driver.G, -1) > 0
        policy = rec.child_visits
        if not bool(((policy.sum(-1) - 1).abs() < 1e-5).all()):
            fail("gomoku main path: a visit policy does not sum to 1")
        if bool((policy[occupied] != 0).any()):
            fail("gomoku main path: an occupied cell got visits")
    log(f"[gomoku] SelfPlayDriver.play: {driver.G} lanes x {S} sims, {K} moves/chunk, "
        f"6x128 ResNet (seeded random init, f32, BN folded), stream route: "
        f"{chunk_s * 1e3:.2f} ms/chunk, {stats['env_steps'] / chunk_s:.2f} env-steps/s, "
        f"launches {launches} = {S} x {moves} moves, max tree depth "
        f"{stats['max_tree_depth']}")
    move_ms = chunk_s * 1e3 / K
    rec_ms, init_ms, rec_call = network_ms(folded, driver, reps=10, init_reps=3)
    dev_net = S * rec_ms + init_ms
    dev_kern = S * (kernels["descend_stream"]["ms"] + kernels["update_edges"]["ms"])
    log(f"[gomoku] per move: {move_ms:.3f} ms = move loop {loop_ms:.3f} + host episode "
        f"cuts {move_ms - loop_ms:.3f}. Device work in the loop: network {dev_net:.3f} "
        f"({S} x {rec_ms:.4f} recurrent + {init_ms:.4f} initial, graph replay; "
        f"{rec_call:.4f} ms per recurrent call from Python) + stream kernels {dev_kern:.3f} "
        f"({S} x (descend {kernels['descend_stream']['ms']:.4f} + update "
        f"{kernels['update_edges']['ms']:.4f}), at the snapshot); the other "
        f"{loop_ms - dev_net - dev_kern:.3f} ms is host time the card waits on and small ops")
    log(f"[gomoku] main path done after {time.perf_counter() - t_path:.1f} s")
    profile_move(driver, loop_ms, means=("descend_stream_kernel",))
    log(f"[gomoku] profile done after {time.perf_counter() - t_path:.1f} s")

    # ---- 8c. ---------------------------------------------------------------
    whole_search_check(driver, folded, "gomoku")

    entries = []
    for name, replaces in (("descend_stream", "muzero_general_tpu/ops/mcts_stream.py:45"),
                           ("update_edges", "muzero_general_tpu/ops/mcts_stream.py:284")):
        k = kernels[name]
        entry = {
            "name": name,
            "route": "cuda",
            "source": CSRC + "mcts_stream.cu",
            "replaces": replaces,
            "launches": launches[name],
            "visits_exact": True,  # the checks failed the run otherwise
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"],
            "call_ms": k["call_ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": None,  # no single PyTorch call descends a tree or runs this update
        }
        if name == "descend_stream":
            entry["design"] = (
                "one warp per lane, one lane a block; per level all five planes as float4 "
                "(4 columns a thread) in one round trip; redux.sync visit sum (shuffles for "
                "fractional counts), redux.sync "
                "max + ballot argmax, the winner's stats by shuffle; divisions only in "
                "column slots with a visited edge, exact via a smem table of 1/b in double; "
                "pUCT numerator tabulated in smem once per launch and predicted from the "
                "edge taken; root legal mask in registers, Philox words while the loads fly")
            entry["per_level_us"] = k["per_level_us"]  # ms / the deepest lane's depth
        else:
            entry["design"] = UPDATE_DESIGN
            entry["floor_ms"] = k["floor_ms"]  # bound 0: the same launch, nothing to update
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# Kernels 8 and 9: the conv probe's two convolutions
# ---------------------------------------------------------------------------

# The conv probe at its default (gomoku's recurrent-inference conv) in bf16
# and in f32, and connect4's at K = 8 leaves per round (2,048 leaves).
CONV_CASES = (((64, 11, 11, 128), "bfloat16"), ((64, 11, 11, 128), "float32"),
              ((2048, 6, 7, 64), "bfloat16"))
CONV_PLAIN_TOL = {"bfloat16": 8e-3, "float32": 1e-5}  # max |d| / max |plain|
CONV_DESIGN = {
    "conv_9dot": "bf16: wgmma m64nBNk16 (BN 64 or 128) on 1-2 consumer warpgroups, both operands "
                 "in 128B-swizzled smem; a TMA ring (up to 12 stages, mbarriers, one producer "
                 "thread) of per-tap pixel boxes and weight slices; box-shaped tiles of the image "
                 "grid, persistent grid, weights resident where they fit; f32: 3-stage cp.async "
                 "ring into 4x8 register tiles on the CUDA cores",
    "conv_im2col": "bf16: wgmma m64nBNk16 from 128B-swizzled smem; the block's patch tile [BM, 9C] "
                   "gathered once into smem by TMA, weight slices through a TMA ring (mbarriers, "
                   "one producer thread), persistent grid; f32: resident 32-pixel patch tile, "
                   "weights through a 3-stage cp.async ring, 4x8 register tiles",
}


def conv_work(B, H, W, C, itemsize):
    """(FLOPs, bytes) of one conv: 2 x 9C x C operations per output pixel;
    the padded input, the weights and the bias read once, the output
    written once."""
    flops = 2 * B * H * W * 9 * C * C
    nbytes = itemsize * (B * (H + 2) * (W + 2) * C + 9 * C * C + C + B * H * W * C)
    return flops, nbytes


def conv_probe_phase():
    """Phase 9, kernels 8 and 9: each kernel against its plain version at
    every case (bf16: within 8e-3 of max |plain|, one bf16 ulp, as the
    tensor cores sum in another order than the plain float32 matmul; f32:
    1e-5); then the probe's entry point once per case, which holds each
    kernel against the library conv (< 2e-2, the probe's own bound) and
    times 50 chained applications of each engine in one CUDA graph. Returns
    the two kernels' entries of the kernels line."""
    import torch.nn.functional as F

    from muzero_general_tpu_torch.tools import conv_probe

    dev = torch.device("cuda")
    names = ("conv_9dot", "conv_im2col")
    rows = {name: [] for name in names}
    for (B, H, W, C), dt in CONV_CASES:
        x, w, b = conv_probe.probe_inputs(B, H, W, C, conv_probe.DTYPES[dt], dev)
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        for name, wk in (("conv_9dot", w.reshape(9, C, C)), ("conv_im2col", w.reshape(9 * C, C))):
            kernel, plain = getattr(conv_probe, name), getattr(conv_probe, name + "_plain")
            with torch.no_grad():
                got, want = kernel(xp, wk, b), plain(xp, wk, b)
                torch.cuda.synchronize()
                rel = conv_probe.relative_error(got, want)
                abs_err = float((got.float() - want.float()).abs().max())
                if not rel <= CONV_PLAIN_TOL[dt]:
                    fail(f"{name} [{B}, {H}, {W}, {C}] {dt}: kernel and plain version differ by "
                         f"{rel!r} of max |plain| > {CONV_PLAIN_TOL[dt]}")
                call = cuda_ms(lambda: kernel(xp, wk, b), 20)
                plain_ms = cuda_ms(lambda: plain(xp, wk, b), 3)
            rows[name].append({"shape": [B, H, W, C], "dtype": dt, "max_abs_err": abs_err,
                               "plain_rel_err": rel, "call_ms": call, "plain_ms": plain_ms})
            log(f"[conv probe] {name} vs plain at [{B}, {H}, {W}, {C}] {dt}: max |d| {abs_err!r} "
                f"= {rel:.2e} of max |plain| (<= {CONV_PLAIN_TOL[dt]}); {call:.4f} ms per call "
                f"(CUDA events, 20 calls), plain {plain_ms:.4f} ms")

    # The probe's entry point, once per case: these kernels' main path.
    conv_probe.conv_9dot.launches = conv_probe.conv_im2col.launches = 0
    for i, ((B, H, W, C), dt) in enumerate(CONV_CASES):
        log(f"[conv probe] python -m muzero_general_tpu_torch.tools.conv_probe --B {B} --H {H} "
            f"--W {W} --C {C} --dtype {dt}:")
        res = conv_probe.main(["--B", str(B), "--H", str(H), "--W", str(W), "--C", str(C),
                               "--dtype", dt])
        flops, nbytes = conv_work(B, H, W, C, 2 if dt == "bfloat16" else 4)
        bnd, by = bound_ms(flops, nbytes,
                           PEAK_BF16_FLOPS if dt == "bfloat16" else PEAK_F32_FLOPS)
        for name in names:
            rows[name][i].update(ms=res["us_per_conv"][name] / 1e3,
                                 library_ms=res["us_per_conv"]["library_conv"] / 1e3,
                                 tflops=res["tflops"][name], library_rel_err=res["errors"][name],
                                 bound_ms=bnd, bound_by=by)
        log(f"[conv probe] bound {bnd * 1e3:.3f} us/conv ({by}: {flops / 1e9:.4f} GFLOP, "
            f"{nbytes / 1e6:.4f} MB); conv_9dot at {100 * bnd / rows['conv_9dot'][i]['ms']:.1f}%, "
            f"conv_im2col at {100 * bnd / rows['conv_im2col'][i]['ms']:.1f}%, library conv at "
            f"{100 * bnd / rows['conv_9dot'][i]['library_ms']:.1f}% of it")
        for name in names:
            row = rows[name][i]
            log(f"[conv probe] {name} [{B}, {H}, {W}, {C}] {dt}: {row['tflops']:.1f} TFLOP/s, "
                f"{100 * bnd / row['ms']:.1f}% of the bound, {row['ms'] / row['library_ms']:.2f}x "
                f"the library conv's time")
    launches = {name: getattr(conv_probe, name).launches for name in names}
    if not all(launches.values()):
        fail(f"conv probe: a kernel was not launched on the probe's path: {launches}")
    entries = []
    for name, replaces in (("conv_im2col", "muzero_general_tpu/tools/conv_probe.py:46"),
                           ("conv_9dot", "muzero_general_tpu/tools/conv_probe.py:31")):
        first = rows[name][0]  # the probe's default, bf16
        entries.append({
            "name": name,
            "route": "cuda",
            "source": CSRC + "conv_probe.cu",
            "replaces": replaces,
            "design": CONV_DESIGN[name],
            # The probe's three runs: per case one check, one warm-up and
            # the 50 applications captured in the CUDA graph (its replays
            # run them again without the wrapper).
            "launches": launches[name],
            "max_abs_err": first["max_abs_err"],
            "ms": first["ms"],  # per conv, 50 chained in one CUDA graph
            "call_ms": first["call_ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],  # F.conv2d (cuDNN) + ReLU, chained the same way
            "cases": rows[name],
        })
    return entries


# ---------------------------------------------------------------------------
# Kernel 10: the stream probe's pointer chase
# ---------------------------------------------------------------------------


def stream_probe_phase(descend_per_level_us):
    """Phase 10, kernel 10, at the probe's [64, 512, 8, 128] (gomoku's packed
    slab is [64, 402, 8, 128]): the kernel against its plain version for 0,
    64 and 128 levels (within 1e-5 relative: the same chain, float32 sums in
    another order); its device time (CUDA graph replay) at L = 0 (floor_ms),
    64 and 128, and one call at L = 64 after a 256 MB write to another
    buffer (cold L2), beside the same call warm; then the probe's entry
    point, which holds the kernel against the float64 numpy reference (rtol
    1e-4) and times it. Returns the kernel's entry of the kernels line."""
    from muzero_general_tpu_torch.tools import stream_probe

    dev = torch.device("cuda")
    B, N, S, A, L = 64, 512, 8, 128, 64
    slab = torch.from_numpy(stream_probe.probe_slab(B, N, S, A)).to(dev)
    levels = {lv: torch.tensor([lv], dtype=torch.int32, device=dev) for lv in (0, L, 2 * L)}
    errs = []
    for lv in (0, L, 2 * L):
        got = stream_probe.pointer_chase(levels[lv], slab)
        want = stream_probe.pointer_chase_plain(levels[lv], slab)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        if not rel <= 1e-5:
            fail(f"pointer_chase at L={lv}: kernel and plain version differ by {rel!r} relative")
        errs.append(float((got - want).abs().max()))
    times = {lv: stream_probe.chase_times(levels[lv], slab) for lv in (0, L, 2 * L)}
    plain_ms = cuda_ms(lambda: stream_probe.pointer_chase_plain(levels[L], slab), 1)
    warm_ms = stream_probe.one_call_ms(levels[L], slab, cold=False)
    cold_ms = stream_probe.one_call_ms(levels[L], slab, cold=True)
    ms = times[L]["us"] / 1e3
    floor_ms = times[0]["us"] / 1e3
    per_level = {lv: times[lv]["us"] / lv for lv in (L, 2 * L)}
    log(f"[stream probe] pointer_chase vs plain at [{B}, {N}, {S}, {A}], L = 0, {L} and {2 * L}: "
        f"max |d| {max(errs)!r} (<= 1e-5 relative); plain {plain_ms:.3f} ms at L = {L}")
    log(f"[stream probe] device ms (CUDA graphs of 20 calls, median of 5): L = 0 {floor_ms:.5f}, "
        f"L = {L} {ms:.5f} ({per_level[L]:.4f} us a level), L = {2 * L} "
        f"{times[2 * L]['us'] / 1e3:.5f} ({per_level[2 * L]:.4f} us a level; "
        f"{100 * (per_level[2 * L] / per_level[L] - 1):+.1f}%); a call from Python "
        f"{times[L]['call_us'] / 1e3:.5f} ms at L = {L} (CUDA events over 20 calls: the "
        f"wrapper's host cost where it exceeds the kernel's)")
    log(f"[stream probe] one call at L = {L}: warm {warm_ms:.5f} ms, cold L2 (after a 256 MB "
        f"write) {cold_ms:.5f} ms ({1e3 * cold_ms / L:.4f} us a level)")

    stream_probe.pointer_chase.launches = 0
    log(f"[stream probe] python -m muzero_general_tpu_torch.tools.stream_probe --B {B} --N {N} "
        f"--S {S} --A {A} --levels {L}:")
    stream_probe.main(["--B", str(B), "--N", str(N), "--S", str(S), "--A", str(A),
                       "--levels", str(L)])
    launches = stream_probe.pointer_chase.launches
    if not launches:
        fail("stream probe: the kernel was not launched on the probe's path")
    # B x L rows of S x A floats read (the data's chain), the level count
    # read and the accumulators written; one add per float read.
    bnd, by = bound_ms(B * L * S * A, B * L * S * A * 4 + 4 + B * 4)
    log(f"[stream probe] bound {bnd * 1e3:.3f} us ({by}: {B * L * S * A * 4 / 1e6:.2f} MB) at L = "
        f"{L}: the kernel at {100 * bnd / ms:.1f}% of it (a chained fetch cannot reach half of "
        f"it; tools/stream_probe_cost.py times the latency floor)")
    log(f"[stream probe] per level: descend_stream {descend_per_level_us:.3f} us (phase 8a, "
        f"its deepest lane) against the row fetch's {per_level[L]:.4f} us: "
        f"{descend_per_level_us / per_level[L]:.2f}x")
    return {
        "name": "pointer_chase",
        "route": "cuda",
        "source": CSRC + "stream_probe.cu",
        "replaces": "muzero_general_tpu/tools/stream_probe.py:27",
        "design": CHASE_DESIGN,
        # kernels run in the probe's run: its checks and calls from Python,
        # and each CUDA-graph replay's calls (counted as they replay)
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,  # device time of one call at L = 64 (CUDA graph replay)
        "call_ms": times[L]["call_us"] / 1e3,
        "floor_ms": floor_ms,
        "per_level_us": per_level[L],
        "per_level_us_at_2L": per_level[2 * L],
        "per_lane_row_ns": 1e3 * per_level[L] / B,
        "ms_at_2L": times[2 * L]["us"] / 1e3,
        "one_call_warm_ms": warm_ms,
        "cold_l2_ms": cold_ms,
        "plain_ms": plain_ms,
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": None,  # no single PyTorch call chases pointers
    }


# ---------------------------------------------------------------------------
# The board-game lanes at the JAX bench's dtype: bfloat16
# ---------------------------------------------------------------------------


def dtype_check(driver, label):
    """One move with the dtypes at use recorded: every conv's weight at use
    must be bfloat16, and every hidden state the search's store hands the
    recurrent inference must be in the driver's activation dtype."""
    from muzero_general_tpu_torch.models.common import Conv
    from muzero_general_tpu_torch.models.resnet import ResMuZero

    weights, hiddens = set(), set()
    recurrent_inference = ResMuZero.recurrent_inference

    def recording_conv_forward(self, x, weight, bias):
        weights.add(weight.dtype)
        return torch.nn.Conv2d._conv_forward(self, x, weight, bias)

    def recording_recurrent_inference(self, hidden, action):
        hiddens.add(hidden.dtype)
        return recurrent_inference(self, hidden, action)

    Conv._conv_forward = recording_conv_forward
    ResMuZero.recurrent_inference = recording_recurrent_inference
    try:
        driver.play_chunk(torch.ones((driver.G,)), 1)
    finally:
        del Conv._conv_forward
        ResMuZero.recurrent_inference = recurrent_inference
    if weights != {torch.bfloat16}:
        fail(f"{label}: conv weights at use were {weights}, not bfloat16")
    if hiddens != {driver.act_dtype}:
        fail(f"{label}: the hidden store held {hiddens}, not {driver.act_dtype}")
    log(f"[{label}] dtypes at use: conv weights {sorted(map(str, weights))}, hidden store "
        f"{sorted(map(str, hiddens))}")


def bf16_lane(label, game, cfg, net, counters, reps=3, means=()):
    """Drive SelfPlayDriver on `game` at the config's bf16 settings: `reps`
    timed chunks after a warm-up; each (function, attribute) counter of
    `counters` must count num_simulations launches per move; the network's
    device time by graph replay; one profiled move; the dtype check.
    Returns the driver and its folded network."""
    from muzero_general_tpu_torch.models import activation_dtype, fold_bn
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    folded = fold_bn(net, activation_dtype(cfg))
    driver = SelfPlayDriver(game.make_env(), net, cfg, seed=0)
    if driver.use_fused or not driver.fold_bn:
        fail(f"{label}: the driver did not route to the staged search with the BN folded")
    for fn, attr in counters:
        setattr(fn, attr, 0)
    chunk_s, loop_ms, stats, _ = timed_play(driver, reps)
    K, S, L = cfg.selfplay_chunk_moves, cfg.num_simulations, cfg.search_batch_leaves
    moves = (reps + 1) * K
    for fn, attr in counters:
        if getattr(fn, attr) != S * moves:
            fail(f"{label}: {fn.__name__}.{attr} = {getattr(fn, attr)} for {moves} moves x {S} "
                 "sims")
    counts = {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counters}
    move_ms = chunk_s * 1e3 / K
    rec_ms, init_ms, rec_call = network_ms(folded, driver, leaves=L, reps=10, init_reps=3)
    dev_net = S // L * rec_ms + init_ms
    steps_per_s = stats["env_steps"] / chunk_s
    log(f"[{label}] SelfPlayDriver.play: {driver.G} lanes x {S} sims ({L} leaves per round), "
        f"{K} moves/chunk, compute {cfg.compute_dtype}, activations {driver.act_dtype}: "
        f"{chunk_s * 1e3:.2f} ms/chunk, {steps_per_s:.2f} env-steps/s; per move {move_ms:.3f} "
        f"ms = move loop {loop_ms:.3f} + host episode cuts {move_ms - loop_ms:.3f}; network "
        f"{dev_net:.3f} ms of device work ({S // L} x {rec_ms:.4f} recurrent at {L * driver.G} "
        f"leaves + {init_ms:.4f} initial, graph replay; {rec_call:.4f} ms per recurrent call "
        f"from Python); launches {counts}")
    profile_move(driver, loop_ms, means)
    dtype_check(driver, label)
    return driver, folded


def bf16_lanes():
    """Phase 11: connect4 at compute_dtype bfloat16, K = 1, with the 64-game
    quality gate; connect4 at bfloat16 with bfloat16 search activations and
    K = 8, with the whole-search check; gomoku at bfloat16 (the settings of
    the JAX bench's lanes, bench.py:163-318)."""
    from muzero_general_tpu_torch.games import connect4, gomoku
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.ops import mcts_kernels, mcts_stream

    d, b = mcts_kernels.descend_planar, mcts_kernels.backprop

    def connect4_config(leaves, acts, moves):
        cfg = connect4.MuZeroConfig()
        cfg.parallel_games, cfg.selfplay_chunk_moves = 256, moves
        cfg.compute_dtype, cfg.search_bf16_activations = "bfloat16", acts
        cfg.search_batch_leaves = leaves
        return cfg

    # K = 1: chunks of 4 moves, a warm-up and one timed (the timed moves cut
    # from 16 in 2 chunks of 8, to make room for phase 18).
    cfg = connect4_config(1, False, 4)
    net = load_pretrained(MuZeroNetwork(cfg), C4_CHECKPOINT)
    _, folded = bf16_lane("connect4 bf16", connect4, cfg, net,
                          [(d, "launches"), (b, "launches")], reps=1)
    quality_gate(cfg, folded, connect4.make_env())

    cfg = connect4_config(8, True, 8)
    net = load_pretrained(MuZeroNetwork(cfg), C4_CHECKPOINT)
    d.launches = b.launches = 0
    driver, folded = bf16_lane("connect4 bf16 K=8", connect4, cfg, net,
                               [(d, "marked_launches"), (b, "pre_marked_launches")],
                               reps=1)  # 3 timed chunks before phase 18
    if d.launches != d.marked_launches or b.launches != b.pre_marked_launches:
        fail("connect4 bf16 K=8: unmarked tree kernels launched")
    whole_search_check(driver, folded, "connect4 bf16 K=8")

    # gomoku: chunks of 1 move (2 before phase 18), a warm-up and one timed.
    cfg = gomoku.MuZeroConfig()
    cfg.parallel_games, cfg.selfplay_chunk_moves = 64, 1
    cfg.compute_dtype = "bfloat16"
    net = MuZeroNetwork(cfg, seed=0)
    bf16_lane("gomoku bf16", gomoku, cfg, net,
              [(mcts_stream.descend_stream, "launches"), (mcts_stream.update_edges, "launches")],
              reps=1, means=("descend_stream_kernel",))


# ---------------------------------------------------------------------------
# The learner (trainer.py): cartpole's main path and the learn loop with the
# fused-search kernel, checkpoints, connect4 and gomoku at full width
# ---------------------------------------------------------------------------

# Card against CPU, float32 (the reductions run in another order): losses
# rtol 1e-4; priorities compared as |value - target| (priority ** (1 /
# PER_alpha): the square root's slope at 0 would magnify any difference
# there) within 1e-4 of the batch's largest |target value| (cartpole's
# reach ~100; after 8 steps the decode carries the params' drift); running
# statistics rtol 1e-4; the FC net's params (a warm Adam state
# from the shipped checkpoint) 1e-5, its Adam moments within 1e-4 of each
# tensor's largest. ResNets: a ReLU pre-activation within rounding of 0 can
# take the other side of the kink on the other device and move that
# position's gradient term (tests/test_torch_checkpoint.py), so >= 99% of
# the params must lie within 1e-5 and none farther than 10 x lr (twice the
# largest step a warm Adam makes). bfloat16 (cuDNN against oneDNN, each
# rounding its own products): losses rtol 2e-2; |value - target| within
# twice bf16's own error on the same batch, the largest difference between
# the CPU's bf16 and f32 steps (bf16 logits are ~4e-3 off, which the
# decode's h^-1 magnifies to O(1) at values near 10); running statistics
# within 5e-3 and rtol 2e-2 (a batch mean of bf16-rounded conv outputs,
# weighted 0.1); >= 99% of params within 1e-4.
LEARN_F32 = dict(loss_rtol=1e-4, gap_tol=1e-4, stats_tol=(1e-5, 1e-4), close=1e-5)
LEARN_BF16 = dict(loss_rtol=2e-2, gap_tol=2.0, stats_tol=(5e-3, 2e-2), close=1e-4)
MOMENT_TOL = 1e-4


def stacked_batches(buf, n):
    """n PER batches assembled on the host and stacked on a leading axis, as
    Learner.train_steps takes them; (their index batches, the stacked dict)."""
    import numpy as np

    parts = [buf.get_batch() for _ in range(n)]
    return [ib for ib, _ in parts], {k: np.stack([b[k] for _, b in parts]) for k in parts[0][1]}


def learner_pair(cfg, path=None, seed=0):
    """A learner on the card and one on the CPU from the same weights: the
    checkpoint's, with its optimizer state, where `path` is given."""
    from muzero_general_tpu_torch.checkpoint import load_checkpoint, restore_learner
    from muzero_general_tpu_torch.trainer import Learner

    pair = []
    for dev in (None, "cpu"):
        learner = Learner(cfg, device=dev, seed=seed)
        if path is not None:
            restore_learner(learner, load_checkpoint(path))
        pair.append(learner)
    return pair


def compare_learners(label, card, cpu, stacked, loss_rtol, gap_tol, stats_tol, close,
                     share=None, moments=False, gap_ref=None):
    """One fused call on `stacked` by each learner; fail unless the card's
    (metrics, priorities) and state equal the CPU's within the stated
    tolerances (LEARN_F32, LEARN_BF16): the priorities' |value - target|
    within gap_tol of the largest |target value|, or, given `gap_ref` (the
    CPU's f32 priorities on the same batch from the same weights), within
    gap_tol times the CPU's own distance from them. `share`
    None: every param within `close`; else that share of the elements, and
    none farther than 10 x lr. Returns the CPU's priorities."""
    t0 = time.perf_counter()
    m_cpu, p_cpu = cpu.train_steps(stacked)
    cpu_s = time.perf_counter() - t0
    m_card, p_card = card.train_steps(stacked)
    err = {}
    for key in ("total_loss", "value_loss", "reward_loss", "policy_loss"):
        got, want = float(m_card[key]), float(m_cpu[key])
        if not abs(got - want) <= loss_rtol * abs(want) or got != got:
            fail(f"{label}: {key} {got!r} on the card, {want!r} on the CPU")
        err[key] = abs(got - want) / abs(want)
    p_card = p_card.cpu()
    if not bool(torch.isfinite(p_card).all()) or p_card.shape != p_cpu.shape:
        fail(f"{label}: priorities {tuple(p_card.shape)} not finite or not the CPU's shape")
    alpha = card.config.PER_alpha
    gap_card, gap_cpu = p_card.double() ** (1 / alpha), p_cpu.double() ** (1 / alpha)
    d = (gap_card - gap_cpu).abs()
    scale = float(abs(stacked["target_value"]).max())
    if gap_ref is None:
        gap_bound = gap_tol * max(scale, 1.0)
    else:
        own = float((gap_cpu - gap_ref.double() ** (1 / alpha)).abs().max())
        gap_bound = gap_tol * own
        log(f"[{label}] bf16's own error on the CPU: |value - target| {own:.4g} from f32's")
    if bool((d > gap_bound).any()):
        fail(f"{label}: |value - target| differs by up to {float(d.max())!r} "
             f"(priorities by {float((p_card - p_cpu).abs().max())!r})")
    err["priorities"] = float(d.max())
    worst, beyond = compare_learner_states(label, card, cpu, stats_tol, close, share, moments)
    err["params"], err["params_beyond"] = worst, beyond
    log(f"[{label}] card vs CPU: losses within {max(err[k] for k in err if 'loss' in k):.3g} "
        f"relative, |value - target| of the priorities {err['priorities']:.3g}, params {worst:.3g} "
        f"({100 * err['params_beyond']:.4f}% beyond {close}), running statistics within "
        f"{stats_tol[0]} + rtol {stats_tol[1]}" + ("; Adam moments and count as the CPU's" if moments else "")
        + f"; largest |target value| {scale:.4g}; the CPU's call took {cpu_s:.2f} s")
    return p_cpu


def compare_learner_states(label, card, cpu, stats_tol, close, share=None, moments=False):
    """Fail unless the card learner's params, running statistics and (with
    `moments`) Adam state equal the CPU's within the tolerances of
    compare_learners. Returns (the largest param difference, the share of
    params beyond `close`)."""
    from muzero_general_tpu_torch.checkpoint import optimizer_state_to_jax

    s_card, s_cpu = card.network.state_dict(), cpu.network.state_dict()
    names = dict(card.network.named_parameters())
    worst, far, total, out = 0.0, 0, 0, 0
    lr_bound = 10 * card.config.lr_init
    for key, want in s_cpu.items():
        got = s_card[key].cpu()
        if key.endswith("num_batches_tracked"):
            continue
        diff = (got.double() - want.double()).abs()
        if key.endswith(("running_mean", "running_var")):
            if bool((diff > stats_tol[0] + stats_tol[1] * want.abs()).any()):
                fail(f"{label}: {key} differs by up to {float(diff.max())!r}")
            continue
        if key not in names:
            continue
        worst = max(worst, float(diff.max()))
        total += diff.numel()
        out += int((diff > close).sum())
        far += int((diff > lr_bound).sum())
    if share is None and out:
        fail(f"{label}: {out} of {total} params farther than {close} from the CPU's "
             f"(largest {worst!r})")
    if share is not None and (out > (1 - share) * total or far):
        fail(f"{label}: {out} of {total} params farther than {close} from the CPU's, "
             f"{far} farther than {lr_bound}")
    if moments:
        a, b = optimizer_state_to_jax(card), optimizer_state_to_jax(cpu)
        for key in ("mu", "nu"):
            for (name, x), (_, y) in zip(_flax_leaves(a[key]), _flax_leaves(b[key])):
                if abs(x - y).max() > MOMENT_TOL * max(abs(y).max(), 1e-30):
                    fail(f"{label}: Adam {key} of {name} differs by {abs(x - y).max()!r}")
        if int(a["count"]) != int(b["count"]):
            fail(f"{label}: Adam count {a['count']} on the card, {b['count']} on the CPU")
    return worst, out / total


def _flax_leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flax_leaves(value, f"{prefix}{key}.")
        else:
            yield prefix + key, value


def learner_rate(learner, calls, label, steps):
    """The card's train-step rate over `calls` ((index batches, stacked
    batches) pairs, assembled before), after one warm-up call."""
    learner.train_steps(calls[0][1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _, stacked in calls:
        learner.train_steps(stacked)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rate = len(calls) * steps / seconds
    log(f"[{label}] {len(calls)} fused calls of {steps} steps in {seconds * 1e3:.1f} ms: "
        f"{rate:.2f} train steps/s ({seconds * 1e3 / (len(calls) * steps):.3f} ms a step)")
    return rate, seconds * 1e3 / len(calls)


def profile_learner(learner, stacked, call_ms, label):
    """One fused call under the profiler: device kernels (launches) per
    training step and the card's busy share of an unprofiled call."""
    steps = next(iter(stacked.values())).shape[0]
    rows, wall_ms, _ = device_trace(lambda: learner.train_steps(stacked))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        log(f"[{label}] profile: device time not measured (the trace holds none)")
        return
    launches = sum(r[2] for r in rows)
    share = 100 * busy_ms / call_ms
    log(f"[{label}] profile of one fused call: {busy_ms:.3f} ms of device kernels, "
        f"{launches} launches ({launches / steps:.1f} per training step, {len(rows)} "
        f"kernel names); {wall_ms:.2f} ms wall profiled; of an unprofiled call "
        f"({call_ms:.2f} ms) the card is busy {share:.1f}%, idle {100 - share:.1f}%")
    for dev_us, key, count in sorted(rows, reverse=True)[:6]:
        log(f"[{label}]   {dev_us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


def cartpole_learner(buf):
    """12a-12c: cartpole's main path (batch 128, unroll 10, Adam, PER,
    8 fused steps) on the card against the CPU, its rate and profile, the
    learn loop and a checkpoint round trip. Returns the fused kernel's
    launches in the loop's play stages."""
    import numpy as np

    from muzero_general_tpu_torch import checkpoint
    from muzero_general_tpu_torch.games.cartpole import MuZeroConfig, make_env
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.ops import mcts_fused
    from muzero_general_tpu_torch.ops.stacking import stack_observations
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver
    from muzero_general_tpu_torch.trainer import Learner

    cfg = MuZeroConfig()
    M = cfg.fused_train_steps
    if not (cfg.optimizer == "Adam" and cfg.PER and cfg.remat_unroll and M == 8):
        fail("cartpole learner: the config is not the main path's")
    # ---- 12a. one fused call, card against CPU ------------------------------
    buf.rng = np.random.default_rng(1)
    _, stacked = stacked_batches(buf, M)
    card, cpu = learner_pair(cfg, CART_CHECKPOINT)
    compare_learners("cartpole learner", card, cpu, stacked, **LEARN_F32, moments=True)

    # ---- 12b. the rate, with the host's batch assembly timed apart ---------
    t0 = time.perf_counter()
    calls = [stacked_batches(buf, M) for _ in range(5)]  # 4 timed (12 before phase 18)
    assemble_ms = (time.perf_counter() - t0) * 1e3 / len(calls)
    log(f"[cartpole learner] host batch assembly: {assemble_ms:.3f} ms per {M} batches "
        f"(get_batch on the C++ assembler and np.stack; {cfg.batch_size} x "
        f"{cfg.num_unroll_steps + 1} positions each)")
    rate, call_ms = learner_rate(card, calls[1:], "cartpole learner", M)
    profile_learner(card, calls[0][1], call_ms, "cartpole learner")

    # ---- 12c. the learn loop ------------------------------------------------
    play_cfg = MuZeroConfig()
    play_cfg.parallel_games, play_cfg.selfplay_chunk_moves = 1024, 8
    net = MuZeroNetwork(play_cfg)
    net.load_state_dict(card.network.state_dict())
    driver = SelfPlayDriver(make_env(), net, play_cfg, seed=3)
    if driver.search_route != "fused":
        fail("learn loop: the driver did not route to the fused search")
    E = play_cfg.encoding_size
    stages = {k: [] for k in ("play", "save", "batches", "train", "priorities", "hand-off")}
    launches, games_saved = 0, 0
    mcts_fused.search.launches = 0
    previous = mcts_fused.fused_weights(driver.network, E).flat.clone()
    for rnd in range(4):
        marks = [time.perf_counter()]
        games, _ = driver.play(temperature=1.0)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        launches += mcts_fused.search.launches
        mcts_fused.search.launches = 0
        for gh in games:
            buf.save_game(gh)
        games_saved += len(games)
        marks.append(time.perf_counter())
        index_batches, stacked = stacked_batches(buf, M)
        marks.append(time.perf_counter())
        _, priorities = card.train_steps(stacked)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        priorities = priorities.cpu().numpy()
        for m, index_batch in enumerate(index_batches):
            buf.update_priorities(priorities[m], index_batch)
        marks.append(time.perf_counter())
        driver.load_weights(card.network.state_dict())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for name, a, b in zip(stages, marks, marks[1:]):
            stages[name].append((b - a) * 1e3)
        # The driver's next search, on the handed-off weights: the kernel
        # against search_plain on the learner's own module.
        packed = mcts_fused.fused_weights(driver.network, E)
        if torch.equal(packed.flat, previous):
            fail(f"learn loop round {rnd}: the driver's weights did not change")
        previous = packed.flat.clone()
        carry = driver._carry
        with torch.no_grad():
            stacked_obs = stack_observations(carry.obs_hist, carry.act_hist, driver.A)
            legal = driver.env.legal_actions_mask(carry.env_state)
            root = mcts_fused.prepare_root(driver.network, stacked_obs, legal,
                                           driver.env.to_play(carry.env_state),
                                           driver.generator, driver.fused_spec)
            args = (root.prior, root.hidden, root.reward, root.to_play, root.legal)
            kw = mcts_fused.search_kwargs(driver.fused_spec) | {"seed": 100 + rnd}
            got = mcts_fused.search(*args, packed, **kw)
            want = mcts_fused.search_plain(*args, mcts_fused.fused_weights(card.network, E),
                                           **kw)
        check_equal(f"learn loop round {rnd}: the driver's search on handed-off weights",
                    got, want, legal, play_cfg.num_simulations)
        mcts_fused.search.launches = 0
    moves = 4 * play_cfg.selfplay_chunk_moves
    if launches != moves:
        fail(f"learn loop: {launches} fused-search launches for {moves} moves")
    log(f"[learn loop] 4 rounds of play ({driver.G} lanes x {play_cfg.num_simulations} sims, "
        f"{play_cfg.selfplay_chunk_moves} moves, fused kernel launched {launches} times), "
        f"save ({games_saved} games in all), {M} batches, one fused train call, priorities "
        f"back, weights to the driver. ms per round: "
        + ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in stages.items())
        + " (medians)")

    # ---- checkpoint round trip ---------------------------------------------
    path = REPO / "results" / "chip_smoke" / "model.checkpoint"
    ckpt = checkpoint.initial_checkpoint()
    checkpoint.sync_checkpoint(ckpt, card, buf)
    checkpoint.save_checkpoint(ckpt, path)
    resumed = Learner(cfg, seed=9)
    checkpoint.restore_learner(resumed, checkpoint.load_checkpoint(path))
    _, stacked = stacked_batches(buf, M)
    (m1, p1), (m2, p2) = card.train_steps(stacked), resumed.train_steps(stacked)
    s1, s2 = card.network.state_dict(), resumed.network.state_dict()
    same = (torch.equal(p1, p2) and all(torch.equal(m1[k], m2[k]) for k in
                                        ("total_loss", "value_loss", "reward_loss", "policy_loss"))
            and all(torch.equal(s1[k], s2[k]) for k in s1))
    if not same or resumed.training_step != card.training_step:
        fail("checkpoint round trip: the resumed learner's next fused call differs")
    log(f"[checkpoint] sync_checkpoint -> save_checkpoint ({path.stat().st_size} bytes) -> "
        f"load_checkpoint -> restore_learner at training_step {ckpt['training_step']}: the next "
        f"fused call ({M} steps) on the card equal bit for bit (losses, priorities, params)")
    return launches


def connect4_learner(buf):
    """12d: connect4's 3 x 64 ResNet (batch 64, unroll 42) from the shipped
    checkpoint with its Adam state, in f32 and bf16: one step on the card
    against the CPU's (running statistics included), and the card's rate."""
    import numpy as np

    from muzero_general_tpu_torch.games.connect4 import MuZeroConfig

    rates, ref = {}, None
    for dtype, tol in (("float32", LEARN_F32), ("bfloat16", LEARN_BF16)):
        cfg = MuZeroConfig()
        cfg.compute_dtype = dtype
        label = f"connect4 learner {dtype}"
        buf.rng = np.random.default_rng(2)
        _, stacked = stacked_batches(buf, 1)
        card, cpu = learner_pair(cfg, C4_CHECKPOINT)
        p_cpu = compare_learners(label, card, cpu, stacked, **tol, share=0.99, gap_ref=ref)
        ref = p_cpu if ref is None else ref
        calls = [stacked_batches(buf, 2)]  # one timed call (2 before phase 18)
        rates[dtype], _ = learner_rate(card, calls, label, 2)
    return rates


def gomoku_learner():
    """12e: gomoku's full config (6 x 128, batch 512, unroll 121) in bf16
    with remat_unroll: one step's time and peak memory; at batch 16, remat
    against the plain unroll (cuDNN deterministic): equal losses,
    priorities, params and running statistics."""
    import numpy as np

    from muzero_general_tpu_torch.games.gomoku import MuZeroConfig
    from muzero_general_tpu_torch.trainer import Learner

    def batch(cfg, seed):
        rng = np.random.default_rng(seed)
        B, U, A = cfg.batch_size, cfg.num_unroll_steps, len(cfg.action_space)
        c, h, w = cfg.observation_shape
        n = cfg.stacked_observations
        return {
            "observation": (rng.random((1, B, c * (n + 1) + n, h, w)) < 0.2).astype(np.float32),
            "action": rng.integers(0, A, (1, B, U + 1)).astype(np.int32),
            "target_value": rng.uniform(-1, 1, (1, B, U + 1)).astype(np.float32),
            "target_reward": rng.uniform(-1, 1, (1, B, U + 1)).astype(np.float32),
            "target_policy": rng.dirichlet(np.ones(A), (1, B, U + 1)).astype(np.float32),
            "weight": rng.uniform(0.1, 1.0, (1, B)).astype(np.float32),
            "gradient_scale": np.full((1, B, U + 1), U, np.float32),
        }

    cfg = MuZeroConfig()
    cfg.compute_dtype = "bfloat16"
    if not (cfg.remat_unroll and cfg.batch_size == 512 and cfg.num_unroll_steps == 121):
        fail("gomoku learner: not the shipped config with remat_unroll")
    learner = Learner(cfg, seed=0)
    data = batch(cfg, 0)
    metrics, _ = learner.train_steps(data)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, prio = learner.train_steps(batch(cfg, 1))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    if not (bool(torch.isfinite(prio).all()) and np.isfinite(float(metrics["total_loss"]))):
        fail("gomoku learner: non-finite loss or priorities")
    log(f"[gomoku learner] bf16, {cfg.blocks} x {cfg.channels}, batch {cfg.batch_size}, unroll "
        f"{cfg.num_unroll_steps}, remat: one step {step_ms:.1f} ms, peak memory {peak / 2**30:.3f} GiB "
        f"(max_memory_allocated), loss {float(metrics['total_loss']):.4f}")

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs = []
        for remat in (True, False):
            small = MuZeroConfig()
            small.compute_dtype, small.batch_size, small.remat_unroll = "bfloat16", 16, remat
            learner = Learner(small, seed=1)
            torch.cuda.reset_peak_memory_stats()
            metrics, prio = learner.train_steps(batch(small, 2))
            torch.cuda.synchronize()
            outs.append((metrics, prio, learner.network.state_dict(),
                         torch.cuda.max_memory_allocated()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (m1, p1, s1, mem1), (m2, p2, s2, mem2) = outs
    if not (torch.equal(p1, p2)
            and all(torch.equal(m1[k], m2[k]) for k in ("total_loss", "value_loss",
                                                         "reward_loss", "policy_loss"))
            and all(torch.equal(s1[k], s2[k]) for k in s1)):
        fail("gomoku learner: remat and the plain unroll differ at batch 16")
    log(f"[gomoku learner] batch 16: remat and the plain unroll equal bit for bit (losses, "
        f"priorities, params, running statistics); peak memory {mem1 / 2**30:.3f} GiB "
        f"against {mem2 / 2**30:.3f} GiB")
    return step_ms, peak


def learner_phase(cart_replay, c4_replay):
    """Phase 12; returns the fused kernel's launches in the learn loop."""
    t0 = time.perf_counter()
    launches = cartpole_learner(cart_replay)
    log(f"[done] cartpole learner after {time.perf_counter() - t0:.1f} s of the phase")
    connect4_learner(c4_replay)
    log(f"[done] connect4 learner after {time.perf_counter() - t0:.1f} s of the phase")
    gomoku_learner()
    log(f"[done] gomoku learner after {time.perf_counter() - t0:.1f} s of the phase")
    return launches


# ---------------------------------------------------------------------------
# Orchestration (muzero.py, evaluate.py): MuZero train / test / load_model,
# the B = 1 evaluation search and the CLI
# ---------------------------------------------------------------------------


class CheckedLaunches:
    """Within `with`, each launch of the search kernels of phases 13, 14 and 16
    (the fused search, the planar descent, the backprop), up to
    `check_first` of each, is held against its plain version on copies of
    the same inputs: the fused search's visits and depth exactly and values
    within VALUE_TOL (check_equal), the tree kernels' outputs and updated
    slabs bit for bit. The wrappers count their launches on the module
    attribute they are called through, so inside `with` they count on the
    checked versions (launches()); the plain versions launch no kernel."""

    NAMES = ("mcts_fused_search", "descend_planar", "backprop")

    def __init__(self, label, check_first=None, quiet=True):
        self.label, self.check_first, self.quiet = label, check_first, quiet
        self.errors = {name: [] for name in self.NAMES}

    def _due(self, name):
        return self.check_first is None or len(self.errors[name]) < self.check_first

    def __enter__(self):
        from muzero_general_tpu_torch.ops import mcts_fused, mcts_kernels

        self.saved = (mcts_fused.search, mcts_kernels.descend_planar, mcts_kernels.backprop)
        search, descend, backprop = self.saved
        errors, label = self.errors, self.label

        def checked_search(*args, **kw):
            got = search(*args, **kw)
            if self._due("mcts_fused_search"):
                want = mcts_fused.search_plain(*args, **kw)
                errors["mcts_fused_search"].append(check_equal(
                    f"{label}, fused search launch {len(errors['mcts_fused_search'])}", got,
                    want, args[4] != 0, kw["num_sims"], quiet=self.quiet))
            return got

        def checked_descend(*args, **kw):
            if kw.get("mark_visits"):
                fail(f"{label}: a marking descent on a K = 1 path")
            got = descend(*args, **kw)
            if self._due("descend_planar"):
                want = mcts_kernels.descend_planar_plain(*args, **kw)
                errors["descend_planar"].append(check_equal_tensors(
                    f"{label}, descend_planar launch {len(errors['descend_planar'])}", got,
                    want, ("parent", "action", "leaf_depth", "path_nodes", "path_actions")))
            return got

        def checked_backprop(*args, **kw):
            due = self._due("backprop")
            twins = [a.clone() if isinstance(a, torch.Tensor) else a for a in args] if due else None
            got = backprop(*args, **kw)
            if due:
                want = mcts_kernels.backprop_plain(*twins, **kw)
                errors["backprop"].append(check_equal_tensors(
                    f"{label}, backprop launch {len(errors['backprop'])}", got, want,
                    ("children_visit", "children_vsum", "root_visit", "root_vsum",
                     "min_value", "max_value")))
            return got

        checked_search.launches = 0
        checked_descend.launches = checked_descend.marked_launches = 0
        checked_backprop.launches = checked_backprop.pre_marked_launches = 0
        self.fns = dict(zip(self.NAMES, (checked_search, checked_descend, checked_backprop)))
        mcts_fused.search, mcts_kernels.descend_planar, mcts_kernels.backprop = (
            checked_search, checked_descend, checked_backprop)
        return self

    def __exit__(self, *exc):
        from muzero_general_tpu_torch.ops import mcts_fused, mcts_kernels

        mcts_fused.search, mcts_kernels.descend_planar, mcts_kernels.backprop = self.saved

    def launches(self):
        return {name: fn.launches for name, fn in self.fns.items()}

    def checked(self):
        """{kernel: (launches checked, max |difference|)} of those checked."""
        return {name: (len(e), max(e)) for name, e in self.errors.items() if e}


def metrics_lines(path):
    lines = [json.loads(x) for x in (path / "metrics.jsonl").read_text().splitlines()]
    return [x for x in lines if "total_reward" in x]


def phase_split(phase_time, wall_s):
    shares = {k: f"{v:.2f} s ({100 * v / wall_s:.1f}%)" for k, v in phase_time.items()}
    rest = wall_s - sum(phase_time.values())
    return ", ".join(f"{k} {v}" for k, v in shares.items()) + (
        f", outside the phases {rest:.2f} s ({100 * rest / wall_s:.1f}%)")


def timed_train(mz):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck = mz.train()
    torch.cuda.synchronize()
    return ck, time.perf_counter() - t0


def test_checked(mz, num_tests, check_first=6, **kwargs):
    """mz.test(...) with the first `check_first` fused-search launches held
    against search_plain on the same inputs (visits and depth exact, values
    within VALUE_TOL). Returns (mean reward, kernel launches, checks)."""
    with CheckedLaunches("test() at G = 1", check_first=check_first, quiet=False) as checked:
        result = mz.test(num_tests=num_tests, **kwargs)
    return result, checked.launches()["mcts_fused_search"], checked.errors["mcts_fused_search"]


# Phases 13a and 15e: cartpole's train() steps, with host replay and with
# device replay (400 before phase 18; a depth cut that makes its room).
CART_TRAIN_STEPS = 200


def orchestration_phase(kernels):
    """Phase 13: the user's entry points on the card. Adds the train and
    test launches to the kernels' entries."""
    import shutil

    import numpy as np

    from muzero_general_tpu_torch import MuZero, evaluate
    from muzero_general_tpu_torch.models import params_to_jax
    from muzero_general_tpu_torch.ops import mcts_fused, mcts_kernels

    root = REPO / "results" / "chip_smoke" / "muzero"
    shutil.rmtree(root, ignore_errors=True)
    fused_entry = next(k for k in kernels if k["name"] == "mcts_fused_search")

    # ---- 13a. cartpole train() at full width, then test() at G = 1 --------
    mz = MuZero("cartpole", {"training_steps": CART_TRAIN_STEPS,
                             "results_path": str(root / "cartpole")})
    cfg = mz.config
    width = (cfg.parallel_games, cfg.num_simulations, cfg.batch_size, cfg.num_unroll_steps,
             cfg.fused_train_steps)
    if width != (16, 50, 128, 10, 8) or cfg.batch_prefetch is not True:
        fail(f"13a: not cartpole's shipped config: {width}")
    mcts_fused.search.launches = 0
    ck, train_s = timed_train(mz)
    launches = mcts_fused.search.launches
    lines = metrics_lines(cfg.results_path)
    if ck["training_step"] != CART_TRAIN_STEPS or launches == 0 or not lines:
        fail(f"13a: train() ended at step {ck['training_step']} with {launches} fused-search "
             f"launches and {len(lines)} logged loops")
    if not all(np.isfinite(ck[k]) for k in ("total_loss", "value_loss", "policy_loss")):
        fail("13a: non-finite losses")
    fused_entry["train_launches"] = launches
    log(f"[muzero cartpole] train() {CART_TRAIN_STEPS} steps in {train_s:.2f} s ({len(lines)} "
        f"loops): {CART_TRAIN_STEPS / train_s:.3f} train steps/s, "
        f"{ck['num_played_steps'] / train_s:.1f} env-steps/s "
        f"({ck['num_played_games']} games, {ck['num_played_steps']} steps saved), "
        f"{ck['num_reanalysed_games']} games reanalysed; fused-search launches {launches}; "
        f"last greedy reward {ck['total_reward']:.1f}, best logged "
        f"{max(x['total_reward'] for x in lines):.1f}; loss {ck['total_loss']:.4f}")
    log(f"[muzero cartpole] phase split: {phase_split(mz.phase_time, train_s)}")
    t0 = time.perf_counter()
    result, test_launches, checks = test_checked(mz, num_tests=2)
    test_s = time.perf_counter() - t0
    if test_launches == 0 or not checks:
        fail("13a: test() did not launch the fused search")
    fused_entry["test_launches"] = test_launches
    log(f"[muzero cartpole] test(num_tests=2): mean reward {result:.1f} in {test_s:.2f} s, "
        f"{test_launches} fused-search launches at G = 1, the first {len(checks)} equal to "
        f"search_plain (max |dvalue| {max(checks)!r})")

    # ---- 13b. load_model of 13a's files, 8 more steps ----------------------
    mz2 = MuZero("cartpole", {"training_steps": CART_TRAIN_STEPS + 8,
                              "results_path": str(root / "resumed")})
    mz2.load_model(checkpoint_path=cfg.results_path / "model.checkpoint",
                   replay_buffer_path=cfg.results_path / "replay_buffer.pkl")
    learner = mz2._restore_state()
    loaded = params_to_jax(learner.network)
    mine, last = dict(_flax_leaves(loaded)), dict(_flax_leaves(ck["weights"]))
    same = mine.keys() == last.keys() and all(np.array_equal(mine[k], last[k]) for k in mine)
    if learner.training_step != CART_TRAIN_STEPS or not same:
        fail(f"13b: load_model restored step {learner.training_step}, weights bit-equal {same}")
    ck2, resume_s = timed_train(mz2)
    if (ck2["training_step"] != CART_TRAIN_STEPS + 8
            or ck2["num_played_games"] < ck["num_played_games"]):
        fail(f"13b: the resumed run ended at step {ck2['training_step']}")
    log(f"[muzero cartpole] load_model + 8 steps: resumed at {CART_TRAIN_STEPS} with 13a's "
        f"weights bit for bit, "
        f"ended at {ck2['training_step']} in {resume_s:.2f} s; played games "
        f"{ck['num_played_games']} -> {ck2['num_played_games']}")

    # ---- 13c. connect4 train() across an opponent evaluation ---------------
    mz3 = MuZero("connect4", {"training_steps": 16, "parallel_games": 64,
                              "results_path": str(root / "connect4")})
    routes = []
    policy_fn = evaluate._mcts_policy_fn

    def recorded_policy_fn(network, config, device):
        fn = policy_fn(network, config, device)
        spec = fn.spec
        routes.append("kernels" if spec.use_kernels else "stream" if spec.use_stream
                      else "plain-op")
        return fn

    evaluate._mcts_policy_fn = recorded_policy_fn
    mcts_kernels.descend_planar.launches = 0
    mcts_kernels.backprop.launches = 0
    try:
        ck3, c4_s = timed_train(mz3)
    finally:
        evaluate._mcts_policy_fn = policy_fn
    c4_launches = {"descend_planar": mcts_kernels.descend_planar.launches,
                   "backprop": mcts_kernels.backprop.launches}
    if ck3["training_step"] != 16 or len(routes) != 1 or not all(c4_launches.values()):
        fail(f"13c: connect4 train() ended at {ck3['training_step']}, {len(routes)} "
             f"evaluation games, kernel launches {c4_launches}")
    for entry in kernels:
        if entry["name"] in c4_launches:
            entry["train_launches"] = c4_launches[entry["name"]]
    log(f"[muzero connect4] train() 16 steps, 64 lanes x {mz3.config.num_simulations} sims, in "
        f"{c4_s:.2f} s; played {ck3['num_played_games']} games; kernel launches {c4_launches}; "
        f"one opponent ({mz3.config.opponent}) evaluation game, its B = 1 search on the "
        f"{routes[0]} route (SearchSpec.from_config's block gate at batch 1): MuZero reward "
        f"{ck3['muzero_reward']:.0f}, opponent {ck3['opponent_reward']:.0f}, "
        f"{ck3['episode_length']} moves")
    log(f"[muzero connect4] phase split: {phase_split(mz3.phase_time, c4_s)}")

    # ---- 13d. the shipped connect4 checkpoint against the expert ------------
    mz4 = MuZero("connect4", {"results_path": str(root / "connect4_test")})
    mz4.load_model(checkpoint_path=C4_CHECKPOINT)
    t0 = time.perf_counter()
    games = 1
    mean = mz4.test(opponent="expert", num_tests=games)
    wins = mean * games / 10  # a win is worth 10
    log(f"[muzero connect4] pretrained vs expert: test(opponent='expert', num_tests={games}) "
        f"mean MuZero reward {mean:.2f}: {wins:.0f}/{games} wins in "
        f"{time.perf_counter() - t0:.2f} s (recorded, not gated; JAX won 20/20)")

    # ---- 13e. the CLI in a subprocess --------------------------------------
    cli = root / "cli"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "muzero_general_tpu_torch", "cartpole",
         json.dumps({"training_steps": 16, "results_path": str(cli)})],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0 or not (cli / "model.checkpoint").exists():
        fail(f"13e: the CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    log(f"[muzero cli] python -m muzero_general_tpu_torch cartpole '{{\"training_steps\": 16, "
        f"...}}': rc 0, {cli / 'model.checkpoint'} written, {time.perf_counter() - t0:.2f} s")
    return {"train_s": train_s, "test_reward": result, "connect4_wins": wins}


# ---------------------------------------------------------------------------
# The remaining device games: gridworld (FC, the fused search), twentyone
# and breakout with the downsampled ResNet (the planar kernels), and the
# diagnosis (diagnose.py)
# ---------------------------------------------------------------------------

# A breakout game of the shipped config lasts up to 2,500 moves; phase 14c
# cuts max_moves (a depth cut) so that its games, and test()'s B = 1 game
# (~14 ms a simulation, host-bound), end inside the phase.
BREAKOUT_MAX_MOVES = 16
# The breakout net on the card against the CPU, from the same weights and
# observations. float32: cuDNN and oneDNN sum the 96 x 96 pyramid's convs in
# other orders (fan-in up to 16 x 9), so outputs agree to float32 rounding
# through 15 convs and a min-max normalize: logits within NET_F32_TOL of
# max(1, max |logit|), hidden states (in [0, 1]) within NET_F32_TOL.
# bfloat16: each device rounds its own bf16 products' partial sums, which
# can flip a rounding of a bf16 activation (2^-8 relative) and carry it
# through the net: NET_BF16_TOL, four bf16 ulps near 1.
NET_F32_TOL = 1e-4
NET_BF16_TOL = 1.6e-2


def randomize_batch_norms(net, seed):
    """Seeded random batch-norm affine parameters and running statistics,
    so the BN fold is not the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                c = module.num_features
                for t, lo, hi in ((module.weight, 0.5, 1.5), (module.running_var, 0.5, 1.5),
                                  (module.bias, -0.2, 0.2), (module.running_mean, -0.2, 0.2)):
                    t.copy_(torch.rand(c, generator=gen) * (hi - lo) + lo)
    return net


def compare_nets(label, card_out, cpu_out, tol):
    """Fail unless the card's (value, reward, policy, hidden) equal the
    CPU's within tol (logits relative to max(1, max |logit|)). Returns the
    largest difference of each."""
    errs = {}
    for name, got, want in zip(("value", "reward", "policy", "hidden"), card_out, cpu_out):
        got, want = got.float().cpu(), want.float()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{label}: {name} {tuple(got.shape)} not finite or not the CPU's shape")
        scale = 1.0 if name == "hidden" else max(1.0, float(want.abs().max()))
        errs[name] = float((got - want).abs().max())
        if errs[name] > tol * scale:
            fail(f"{label}: {name} differs from the CPU's by {errs[name]!r} (tol {tol} x "
                 f"{scale:.4g})")
    return errs


def remaining_games_phase(kernels):
    """Phase 14: the remaining device games and the diagnosis, through the
    user's entry points. Adds each game's launches to the kernels' entries."""
    import importlib.util
    import os
    import shutil
    import tempfile

    import numpy as np

    from muzero_general_tpu_torch import MuZero
    from muzero_general_tpu_torch.checkpoint import load_replay_buffer
    from muzero_general_tpu_torch.config import load_game_module
    from muzero_general_tpu_torch.diagnose import DiagnoseModel
    from muzero_general_tpu_torch.models import MuZeroNetwork, activation_dtype, fold_bn
    from muzero_general_tpu_torch.models import params_from_jax
    from muzero_general_tpu_torch.ops import mcts_fused, mcts_kernels
    from muzero_general_tpu_torch.replay import ReplayBuffer
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    t_phase = time.perf_counter()
    root = REPO / "results" / "chip_smoke" / "games"
    shutil.rmtree(root, ignore_errors=True)
    entries = {k["name"]: k for k in kernels}
    path_kernels = {"fused": ("mcts_fused_search",), "staged": ("descend_planar", "backprop")}

    def zero_counts():
        mcts_fused.search.launches = 0
        mcts_kernels.descend_planar.launches = 0
        mcts_kernels.backprop.launches = 0

    def counts():
        return {"mcts_fused_search": mcts_fused.search.launches,
                "descend_planar": mcts_kernels.descend_planar.launches,
                "backprop": mcts_kernels.backprop.launches}

    def add_launches(game, stage, launched):
        for name, n in launched.items():
            if n:
                entries[name][f"{game}_{stage}_launches"] = n

    # ---- 14a. self-play at the shipped widths -------------------------------
    folded_breakout = None
    for game, route in (("gridworld", "fused"), ("twentyone", "staged"),
                        ("breakout", "staged")):
        module = load_game_module(game)
        cfg = module.MuZeroConfig()
        net = MuZeroNetwork(cfg, seed=0)
        if game == "breakout":
            randomize_batch_norms(net, 1)
        driver = SelfPlayDriver(module.make_env(), net, cfg, seed=0)
        if driver.search_route != route or (route == "staged" and not driver.spec.use_kernels):
            fail(f"14a {game}: route {driver.search_route}, kernels {driver.spec.use_kernels}")
        G, K, S = driver.G, cfg.selfplay_chunk_moves, cfg.num_simulations
        # One chunk with every launch held against the plain version, then
        # timed chunks (timed_play: a warm-up and 2), unchecked.
        with CheckedLaunches(f"{game} self-play") as checked:
            driver.play(temperature=1.0)
        zero_counts()
        chunk_s, loop_ms, stats, _ = timed_play(driver, 2)
        launched = {name: checked.launches()[name] + counts()[name]
                    for name in path_kernels[route]}
        moves = 4 * K
        per_move = 1 if route == "fused" else S
        for name, n in launched.items():
            if n != per_move * moves:
                fail(f"14a {game}: {name} launched {n} times for {moves} moves")
        done = checked.checked()
        if set(done) != set(path_kernels[route]):
            fail(f"14a {game}: checked {sorted(done)}")
        add_launches(game, "selfplay", launched)
        move_ms = chunk_s * 1e3 / K
        log(f"[{game}] SelfPlayDriver.play, shipped width: {G} lanes x {S} sims, {K} moves a "
            f"chunk, {route} route: {chunk_s * 1e3:.2f} ms/chunk, "
            f"{stats['env_steps'] / chunk_s:.1f} env-steps/s, {move_ms:.3f} ms/move (move "
            f"loop {loop_ms:.3f}); launches {launched} over {moves} moves; each launch of "
            f"the first chunk against its plain version: " + ", ".join(
                f"{name} {n} launches equal (max |d| {e!r})" for name, (n, e) in done.items()))
        if game == "breakout":
            folded_breakout = fold_bn(net, activation_dtype(cfg))
            rec_ms, init_ms, rec_call = network_ms(folded_breakout, driver)
            log(f"[breakout] network, folded f32, {G} lanes: initial inference (the 96 x 96 "
                f"downsample pyramid) {init_ms:.4f} ms, recurrent {rec_ms:.4f} ms (device "
                f"time, CUDA graph replay), {rec_call:.4f} ms per recurrent call from Python; "
                f"per move {S} x recurrent + initial = {S * rec_ms + init_ms:.3f} ms of "
                f"{loop_ms:.3f}")
            breakout_obs = driver.env.observation(driver._carry.env_state)
    log(f"[done] 14a after {time.perf_counter() - t_phase:.1f} s of the phase")

    # ---- 14b. the breakout net on the card against the CPU ------------------
    actions = torch.arange(breakout_obs.shape[0], device="cuda") % 4
    for dtype, tol in (("float32", NET_F32_TOL), ("bfloat16", NET_BF16_TOL)):
        cfg = load_game_module("breakout").MuZeroConfig()
        cfg.compute_dtype = dtype
        cfg.search_bf16_activations = dtype == "bfloat16"
        card = randomize_batch_norms(MuZeroNetwork(cfg, seed=2), 3)
        cpu = MuZeroNetwork(cfg, device="cpu", seed=2)
        cpu.load_state_dict(card.state_dict())
        for variant, a, b in (("unfolded", card, cpu),
                              ("folded", fold_bn(card, activation_dtype(cfg)),
                               fold_bn(cpu, activation_dtype(cfg)))):
            with torch.no_grad():
                got = a.initial_inference(breakout_obs)
                want = b.initial_inference(breakout_obs.cpu())
                e0 = compare_nets(f"14b breakout {dtype} {variant} initial", got, want, tol)
                got = a.recurrent_inference(want[3].to("cuda"), actions)
                want = b.recurrent_inference(want[3], actions.cpu())
                e1 = compare_nets(f"14b breakout {dtype} {variant} recurrent", got, want, tol)
            log(f"[breakout net] {dtype} {variant} (hidden {tuple(got[3].shape)} "
                f"{got[3].dtype}), card vs CPU at {breakout_obs.shape[0]} observations: "
                f"initial {e0}, recurrent {e1} (tol {tol})")

    # ---- 14c. MuZero(game).train() then test() -------------------------------
    trained = {}
    for game, route, overrides in (
            ("gridworld", "fused", {}), ("twentyone", "staged", {}),
            ("breakout", "staged", {"max_moves": BREAKOUT_MAX_MOVES})):
        mz = MuZero(game, dict(overrides, training_steps=16,
                               results_path=str(root / game)))
        cfg = mz.config
        zero_counts()
        ck, train_s = timed_train(mz)
        launched = {name: counts()[name] for name in path_kernels[route]}
        lines = metrics_lines(cfg.results_path)
        if ck["training_step"] != 16 or not all(launched.values()) or not lines:
            fail(f"14c {game}: train() ended at step {ck['training_step']}, launches "
                 f"{launched}, {len(lines)} logged loops")
        if not all(np.isfinite(ck[k]) for k in ("total_loss", "value_loss", "policy_loss")):
            fail(f"14c {game}: non-finite losses")
        add_launches(game, "train", launched)
        cut = f"; max_moves cut to {BREAKOUT_MAX_MOVES} (depth cut)" if overrides else ""
        log(f"[muzero {game}] train() 16 steps at the shipped width ({cfg.parallel_games} "
            f"lanes x {cfg.num_simulations} sims, batch {cfg.batch_size}, unroll "
            f"{cfg.num_unroll_steps}{cut}) in {train_s:.2f} s: {ck['num_played_games']} "
            f"games, {ck['num_played_steps']} steps, {ck['num_played_steps'] / train_s:.1f} "
            f"env-steps/s; launches {launched}; loss {ck['total_loss']:.4f} (that of the "
            f"last checkpoint interval, every {cfg.checkpoint_interval} steps; 0 before one)")
        log(f"[muzero {game}] phase split: {phase_split(mz.phase_time, train_s)}")
        zero_counts()
        t0 = time.perf_counter()
        if route == "fused":
            result, test_launches, errs = test_checked(mz, num_tests=1)
            if not test_launches or not errs:
                fail(f"14c {game}: test() did not launch the fused search")
            entries["mcts_fused_search"][f"{game}_test_launches"] = test_launches
            how = (f"{test_launches} fused-search launches at G = 1, the first {len(errs)} "
                   f"equal to search_plain (max |dvalue| {max(errs)!r})")
        else:
            result = mz.test(num_tests=1)
            if any(counts().values()):
                fail(f"14c {game}: test() at G = 1 launched {counts()}")
            how = "the B = 1 search on the plain-op route (the block gate closes at 1 lane)"
        log(f"[muzero {game}] test(num_tests=1): reward {result:.3f} in "
            f"{time.perf_counter() - t0:.2f} s, {how}")
        trained[game] = mz

    # One breakout learner step on the card against the CPU's, from 14c's
    # checkpoint, optimizer state and replay buffer.
    mz = trained["breakout"]
    saved = load_replay_buffer(mz.config.results_path / "replay_buffer.pkl")
    buf = ReplayBuffer(mz.config, saved["buffer"], saved["num_played_games"],
                       saved["num_played_steps"])
    buf.rng = np.random.default_rng(4)
    _, stacked = stacked_batches(buf, 1)
    card, cpu = learner_pair(mz.config, mz.config.results_path / "model.checkpoint")
    compare_learners("breakout learner", card, cpu, stacked, **LEARN_F32, share=0.99)
    log(f"[done] 14c after {time.perf_counter() - t_phase:.1f} s of the phase")

    # ---- 14d. the diagnosis ---------------------------------------------------
    # The plots need matplotlib and seaborn (the tree graphviz); where this
    # machine lacks them the trajectories are compared without the plots,
    # which the CPU tests draw (tests/test_torch_diagnose.py).
    plotting = all(importlib.util.find_spec(m) for m in ("matplotlib", "seaborn"))
    tree_plot = importlib.util.find_spec("graphviz") is not None
    for game, path, horizon in (
            ("gridworld", trained["gridworld"].config.results_path / "model.checkpoint", 5),
            ("connect4", C4_CHECKPOINT, 1)):
        mz = MuZero(game, {"results_path": str(root / f"diagnose_{game}")})
        mz.load_model(checkpoint_path=path)
        mz.network.load_state_dict(params_from_jax(mz.checkpoint["weights"]))
        dm = DiagnoseModel(mz.network, mz.config)
        route = ("kernels" if dm.spec.use_kernels else "stream" if dm.spec.use_stream
                 else "plain-op")
        zero_counts()
        t0 = time.perf_counter()
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)  # plot_mcts writes mcts.pdf (or mcts.gv) here
            try:
                virtual, real, divergence = dm.compare_virtual_with_real_trajectories(
                    mz.make_env(), horizon, plot=False)
                if plotting:
                    for info in (virtual, real):
                        info.plot_trajectory(save_dir=tmp, show=False)
                    dm.close_all()
            finally:
                os.chdir(cwd)
            written = sorted(p.name for p in pathlib.Path(tmp).iterdir())
        if len(virtual.action_history) != horizon or not real.mcts_depth:
            fail(f"14d {game}: virtual actions {virtual.action_history}, real depths "
                 f"{real.mcts_depth}")
        values = virtual.root_value_after_planning + real.root_value_after_planning
        if not all(np.isfinite(values)):
            fail(f"14d {game}: non-finite root values")
        if (tree_plot and not any(name.startswith("mcts") for name in written)
                or plotting and sum(name.endswith(".png") for name in written) < 10):
            fail(f"14d {game}: the plots wrote {written}")
        if any(counts().values()):
            fail(f"14d {game}: the B = 1 diagnosis searches launched {counts()}")
        log(f"[diagnose {game}] compare_virtual_with_real_trajectories(horizon={horizon}) "
            f"in {time.perf_counter() - t0:.2f} s" + (" with the plots" if written else "")
            + ", its searches on the "
            f"{route} route (B = 1): virtual actions {virtual.action_history}, real "
            f"{real.action_history}, divergence {divergence}, depths {virtual.mcts_depth} / "
            f"{real.mcts_depth}; " + (f"{len(written)} plot files written" if written else
                                      "no plots: matplotlib, seaborn and graphviz are not "
                                      "installed on this machine"))
    seconds = time.perf_counter() - t_phase
    log(f"[done] phase 14 in {seconds:.1f} s")
    return seconds


# ---------------------------------------------------------------------------
# The Gumbel search (ops/gumbel.py) and device replay (ops/device_replay.py)
# ---------------------------------------------------------------------------

# Phase 15a's tables: a "table network" over TABLE_IDS hidden ids, whose
# logits are gathered from the same float32 tables on the card and on the
# CPU (bit-identical in both places, as the kernel checks' inputs are).
TABLE_IDS, TABLE_SUPPORT = 97, 5
# Root values of the lanes whose trees equal the CPU's. The table network:
# the support decode rounds per device (float32 ulps through h^-1), in a
# mean over up to 50 backed-up values: GUMBEL_VALUE_RTOL, GUMBEL_VALUE_ATOL.
# The shipped nets: cuDNN's float32 convs (no TF32) sum in other orders, and
# may take other algorithms, than oneDNN's, so logits agree within phase
# 14b's NET_F32_TOL of max(1, |logit|), which the decode's h^-1 magnifies
# up to ~7x at connect4's |values| near 10: GUMBEL_NET_VALUE_ATOL.
GUMBEL_VALUE_RTOL, GUMBEL_VALUE_ATOL = 1e-4, 1e-4
GUMBEL_NET_VALUE_ATOL = 1e-2
# Phase 15b's connect4 lanes play chunks of this many moves (the shipped 8;
# a depth cut: a 200-simulation Gumbel move takes ~7 s on the plain-op
# route, host-bound, so a warm-up and one timed chunk of one move keep the
# phase near its time).
GUMBEL_C4_CHUNK_MOVES = 1
# Phase 15c's Gumbel train() steps: 50 (a depth cut from 200, then 100,
# which keeps the whole script inside its time limit on a slower host).
GUMBEL_TRAIN_STEPS = 50


def table_net(tables, A, device):
    """(initial_fn, recurrent_fn) of the table network on `device`: the
    hidden state is the id, the recurrent step maps (id, a) to
    (id * A + a + 1) % TABLE_IDS."""
    tv, tr, tp = (torch.from_numpy(t).to(device) for t in tables)

    def initial_fn(obs):
        ids = obs[:, 0].long()
        return tv[ids], torch.zeros_like(tr[ids]), tp[ids], obs

    def recurrent_fn(hidden, action):
        ids = (hidden[:, 0].long() * A + action.long() + 1) % TABLE_IDS
        return tv[ids], tr[ids], tp[ids], ids[:, None].to(torch.float32)

    return initial_fn, recurrent_fn


def gumbel_invariants(label, out, legal, spec):
    """Visit sums equal the simulation count, each lane's root visits
    follow the halving table for its m, illegal actions get 0 visits, the
    improved policy sums to 1 over the legal actions."""
    import numpy as np

    from muzero_general_tpu_torch.ops import gumbel as gumbel_ops

    visits = out.root_visit_counts.cpu().numpy()
    legal = legal.cpu().numpy()
    S = spec.num_simulations
    if not (visits.sum(-1) == S).all() or visits[~legal].any():
        fail(f"{label}: visit sums {sorted(set(visits.sum(-1).tolist()))} (want {S}) or "
             f"visits on illegal actions")
    m_cap = min(spec.max_considered_actions, legal.shape[1])
    table = gumbel_ops.table_of_considered_visits(m_cap, S)
    for b in range(visits.shape[0]):
        m = int(np.clip(legal[b].sum(), 1, m_cap))
        # Each simulation takes a candidate from its prescribed count c to
        # c + 1, so the actions with at least k visits are as many as the
        # simulations that prescribed k - 1.
        prescribed = np.bincount(table[m], minlength=S + 1)
        got = [int((visits[b] >= k).sum()) for k in range(1, S + 1)]
        if got != prescribed[:S].tolist():
            fail(f"{label}: lane {b} (m = {m}) visits {visits[b].tolist()} do not follow the "
                 f"halving table {table[m].tolist()}")
    pol = out.improved_policy.cpu().numpy()
    if np.abs(pol.sum(-1) - 1).max() > 1e-5 or (pol[~legal] != 0).any():
        fail(f"{label}: the improved policy does not sum to 1 over the legal actions")


def gumbel_card_vs_cpu(label, card_fns, cpu_fns, obs, legal, to_play, spec, gumbel,
                       exact=True):
    """run_gumbel_mcts on the card and on the CPU with the same injected
    Gumbel draw. exact: every lane's tree (children and visits), depth and
    both actions must equal the CPU's, root values within GUMBEL_VALUE_RTOL;
    else the shares of lanes whose root visits and whose whole trees equal
    the CPU's are reported, and the latter's root values held to
    GUMBEL_NET_VALUE_ATOL. Returns (card output, tree share)."""
    from muzero_general_tpu_torch.ops import gumbel as gumbel_ops

    secs = []
    outs = []
    for fns, dev in ((card_fns, "cuda"), (cpu_fns, "cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = gumbel_ops.run_gumbel_mcts(
                *fns, obs.to(dev), legal.to(dev), to_play.to(dev), None, spec,
                gumbel=gumbel.to(dev))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
    card, cpu = outs
    gumbel_invariants(f"{label} (card)", card, legal, spec)
    same_root = (card.root_visit_counts.cpu() == cpu.root_visit_counts).all(-1)
    for name in ("max_tree_depth", "action", "greedy_action"):
        same_root &= getattr(card, name).cpu() == getattr(cpu, name)
    same_tree = same_root.clone()
    for name in ("children_index", "children_visit"):
        same_tree &= (getattr(card.tree, name).cpu() == getattr(cpu.tree, name)).flatten(1).all(-1)
    root_share, tree_share = float(same_root.float().mean()), float(same_tree.float().mean())
    if exact and tree_share < 1.0:
        fail(f"{label}: {int((~same_tree).sum())} lanes differ from the CPU's in their trees, "
             f"depth or actions")
    got, want = card.root_value.cpu()[same_tree], cpu.root_value[same_tree]
    err = float((got - want).abs().max()) if bool(same_tree.any()) else 0.0
    rtol, atol = (GUMBEL_VALUE_RTOL, GUMBEL_VALUE_ATOL) if exact else (0.0, GUMBEL_NET_VALUE_ATOL)
    if bool(((got - want).abs() > atol + rtol * want.abs()).any()):
        fail(f"{label}: root values differ from the CPU's by {err!r} on equal trees")
    log(f"[gumbel] {label}: {obs.shape[0]} lanes x {spec.num_simulations} sims, m "
        f"{spec.max_considered_actions}: card {secs[0]:.2f} s, CPU {secs[1]:.2f} s (host "
        f"clock); invariants hold; lanes with the CPU's root visits, depth and actions "
        f"{100 * root_share:.1f}%, with its whole tree {100 * tree_share:.1f}%, their root "
        f"values within {err:.3g} (|value| up to {float(want.abs().max()) if len(want) else 0:.3g});"
        f" max depth {int(card.max_tree_depth.max())}")
    return card, tree_share


def gumbel_selfplay(label, module, cfg, net, reps):
    """One chunk and `reps` timed ones of the Gumbel driver (timed_play),
    then one move profiled for its device launches; fail unless the port's
    kernels launched as expected: none of the search's (the Gumbel search
    has none, as in JAX) and, for a folded ResNet, the fused 3x3 conv
    wherever ops/conv3x3.py's rule sends a conv (one launch a move for
    connect4's representation conv at 64 lanes)."""
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver
    from muzero_general_tpu_torch.tools.profiling import launches_since

    env = module.make_env()
    driver = SelfPlayDriver(env, net, cfg, seed=0)
    if driver.search_route != "staged" or not driver.use_gumbel:
        fail(f"{label}: route {driver.search_route}, Gumbel {driver.use_gumbel}")
    before = kernel_counts()
    chunk_s, loop_ms, stats, records = timed_play(driver, reps)
    moves = (reps + 1) * cfg.selfplay_chunk_moves
    conv = conv3x3_launches_a_move(cfg, driver.G) * moves if driver.fold_bn else 0
    want = {"conv3x3": conv} if conv else {}
    launched = launches_since(before)
    if launched != want:
        fail(f"{label}: the Gumbel route launched the port's kernels {launched}, want {want}")
    for rec in records:
        pol = rec.child_visits
        if bool(((pol.sum(-1) - 1).abs() > 1e-5).any()):
            fail(f"{label}: improved-policy targets do not sum to 1")
    K, S = cfg.selfplay_chunk_moves, cfg.num_simulations
    move_ms = chunk_s * 1e3 / K
    rows, wall_ms, _ = device_trace(lambda: driver.play_chunk(torch.ones((driver.G,)), 1))
    launches = sum(r[2] for r in rows)
    busy_ms = sum(r[0] for r in rows) / 1e3
    busy = (f"{busy_ms:.2f} ms of device kernels, busy {100 * busy_ms / loop_ms:.1f}% of an "
            f"unprofiled move" if busy_ms > 0 else "device time: not measured")
    log(f"[gumbel {label}] SelfPlayDriver.play under use_gumbel_mcts: {driver.G} lanes x {S} "
        f"sims, m {cfg.gumbel_max_considered_actions}, {K} moves a chunk: "
        f"{chunk_s * 1e3:.2f} ms/chunk, {stats['env_steps'] / chunk_s:.1f} env-steps/s, "
        f"{move_ms:.3f} ms/move (move loop {loop_ms:.3f}); one move profiled: {launches} "
        f"device launches ({launches / S:.1f} per simulation), {busy}; {wall_ms:.1f} ms "
        f"wall profiled; the port's kernels: {launched or 'no launch'} over {moves} moves "
        f"(no search kernel, as in JAX); max tree depth {stats['max_tree_depth']}")
    return driver


def gumbel_phase():
    """Phases 15a-15c."""
    import numpy as np

    from muzero_general_tpu_torch import MuZero
    from muzero_general_tpu_torch.games import cartpole, connect4
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.ops import gumbel as gumbel_ops

    t_phase = time.perf_counter()
    # ---- 15a. card against CPU ----------------------------------------------
    rng = np.random.default_rng(15)
    B, A, S = 64, 7, 50
    nbins = 2 * TABLE_SUPPORT + 1
    tables = tuple(rng.normal(size=(TABLE_IDS, n)).astype(np.float32)
                   for n in (nbins, nbins, A))
    obs = torch.from_numpy(rng.integers(0, TABLE_IDS, (B, 1)).astype(np.float32))
    legal = torch.from_numpy(rng.random((B, A)) < 0.7)
    legal[torch.arange(B), torch.from_numpy(rng.integers(0, A, B))] = True
    to_play = torch.from_numpy(rng.integers(0, 2, B).astype(np.int32))
    gumbel = torch.from_numpy(rng.gumbel(size=(B, A)).astype(np.float32))
    for m in (16, 4):
        spec = gumbel_ops.GumbelSpec(num_simulations=S, num_players=2, discount=1.0,
                                     support_size=TABLE_SUPPORT, max_depth=S,
                                     max_considered_actions=m)
        gumbel_card_vs_cpu(f"table network, m {m}", table_net(tables, A, "cuda"),
                           table_net(tables, A, "cpu"), obs, legal, to_play, spec, gumbel)

    shipped = {}
    for game, module, path, sims, lanes in (
            ("cartpole", cartpole, CART_CHECKPOINT, 16, 256),
            ("connect4", connect4, C4_CHECKPOINT, 200, 16)):
        cfg = module.MuZeroConfig()
        cfg.use_gumbel_mcts, cfg.num_simulations = True, sims
        cfg.gumbel_max_considered_actions = 16
        card = load_pretrained(MuZeroNetwork(cfg), path).eval()
        cpu = load_pretrained(MuZeroNetwork(cfg, device="cpu"), path).eval()
        env, gen = module.make_env(device="cpu"), torch.Generator().manual_seed(3)
        state = env.reset(lanes, gen)
        for _ in range(4 if game == "connect4" else 0):
            state, _, _ = env.step(state, env.random_legal_action(state, gen), gen)
        obs = env.observation(state)
        legal, to_play = env.legal_actions_mask(state), env.to_play(state)
        spec = gumbel_ops.GumbelSpec.from_config(cfg)
        draw = gumbel_ops.sample_gumbel(tuple(legal.shape), gen)
        shipped[game] = (cfg, card)
        gumbel_card_vs_cpu(f"{game} shipped checkpoint", (card.initial_inference,
                           card.recurrent_inference), (cpu.initial_inference,
                           cpu.recurrent_inference), obs, legal, to_play, spec, draw,
                           exact=False)
    log(f"[done] 15a after {time.perf_counter() - t_phase:.1f} s of the phase")

    # ---- 15b. Gumbel self-play at the shipped widths --------------------------
    cfg, net = shipped["cartpole"]
    cfg.parallel_games = 4096
    gumbel_selfplay("cartpole", cartpole, cfg, net, reps=1)  # 2 timed chunks before phase 18
    cfg, net = shipped["connect4"]
    cfg.parallel_games, cfg.selfplay_chunk_moves = 64, GUMBEL_C4_CHUNK_MOVES
    gumbel_selfplay("connect4", connect4, cfg, net, reps=1)
    log(f"[gumbel connect4] cuts: 64 lanes (the shipped config's 64; phase 4b runs 256), "
        f"chunks of {GUMBEL_C4_CHUNK_MOVES} move (shipped 8), 1 timed chunk: depth cuts")
    log(f"[done] 15b after {time.perf_counter() - t_phase:.1f} s of the phase")

    # ---- 15c. Gumbel training, then test() ------------------------------------
    import shutil

    root = REPO / "results" / "chip_smoke" / "gumbel"
    shutil.rmtree(root, ignore_errors=True)
    steps = GUMBEL_TRAIN_STEPS
    mz = MuZero("cartpole", {"use_gumbel_mcts": True, "num_simulations": 16,
                             "gumbel_max_considered_actions": 16, "training_steps": steps,
                             "results_path": str(root)})
    before = kernel_counts()
    ck, train_s = timed_train(mz)
    lines = metrics_lines(mz.config.results_path)
    if ck["training_step"] != steps or not lines or kernel_counts() != before:
        fail(f"15c: Gumbel train() ended at {ck['training_step']}, {len(lines)} logged loops, "
             f"kernel launches {kernel_counts()}")
    if not all(np.isfinite(ck[k]) for k in ("total_loss", "value_loss", "policy_loss")):
        fail("15c: non-finite losses")
    log(f"[muzero cartpole gumbel] train() {steps} steps (16 lanes x 16 sims, m 16; a depth "
        f"cut from 200) in {train_s:.2f} s: {steps / train_s:.3f} train steps/s, "
        f"{ck['num_played_steps'] / train_s:.1f} env-steps/s ({ck['num_played_games']} games); "
        f"loss {ck['total_loss']:.4f}; no kernel launch")
    log(f"[muzero cartpole gumbel] phase split: {phase_split(mz.phase_time, train_s)}")
    t0 = time.perf_counter()
    result = mz.test(num_tests=1)
    if kernel_counts() != before or not np.isfinite(result):
        fail(f"15c: test() gave {result} with kernel launches {kernel_counts()}")
    log(f"[muzero cartpole gumbel] test(num_tests=1), the G = 1 Gumbel search at temperature "
        f"0 (greedy actions): reward {result:.1f} in {time.perf_counter() - t0:.2f} s")
    seconds = time.perf_counter() - t_phase
    log(f"[done] 15a-15c in {seconds:.1f} s")
    return seconds


def ring_pair(cfg, games, capacity):
    """The same games saved into a ring on the card and one on the CPU."""
    from muzero_general_tpu_torch.ops import device_replay as dr

    rings = []
    for dev in ("cuda", "cpu"):
        ring = dr.init_replay(capacity, cfg.max_moves, tuple(cfg.observation_shape),
                              len(cfg.action_space), dev)
        t0 = time.perf_counter()
        for chunk, valid in dr.pad_games_np(games, cfg.max_moves, tuple(cfg.observation_shape),
                                            len(cfg.action_space), 8):
            dr.save_games(ring, {k: torch.from_numpy(v).to(dev) for k, v in chunk.items()},
                          torch.from_numpy(valid).to(dev), td_steps=cfg.td_steps,
                          discount=cfg.discount, per_alpha=cfg.PER_alpha,
                          use_per=bool(cfg.PER))
        torch.cuda.synchronize()
        rings.append((ring, time.perf_counter() - t0))
    return rings


# Device replay, card against CPU: integer fields, observations, rewards and
# policies are copies and gathers (exact); priorities |v - target| ** alpha
# and value targets sum td_steps float32 terms, which the card's kernels may
# add in another order or contract into FMAs: RING_ULPS float32 ulps of the
# largest |target| (the IS weights likewise, relative).
RING_ULPS = 64


def ring_close(label, name, got, want, scale):
    got = got.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{label}: {name} {got.dtype} {tuple(got.shape)} vs {want.dtype} "
             f"{tuple(want.shape)}")
    if not got.is_floating_point() or name in ("observations", "rewards", "child_visits",
                                               "root_values", "observation", "target_reward",
                                               "target_policy", "gradient_scale"):
        if not torch.equal(got, want):
            fail(f"{label}: {name} differs from the CPU's")
        return 0.0
    err = float((got.double() - want.double()).abs().max())
    bound = RING_ULPS * float(torch.finfo(torch.float32).eps) * max(1.0, scale)
    if not err <= bound:
        fail(f"{label}: {name} differs from the CPU's by {err!r} (bound {bound:.3g})")
    return err


def device_replay_phase(cart_replay, c4_replay, kernels, host_train_s):
    """Phases 15d and 15e."""
    import numpy as np

    from muzero_general_tpu_torch import MuZero
    from muzero_general_tpu_torch import muzero as muzero_lib
    from muzero_general_tpu_torch.games import cartpole
    from muzero_general_tpu_torch.ops import device_replay as dr
    from muzero_general_tpu_torch.ops import mcts_fused
    from muzero_general_tpu_torch.trainer import Learner

    t_phase = time.perf_counter()
    # ---- 15d. the ring, batches and a device train round, card against CPU ---
    for label, buf in (("cartpole", cart_replay), ("connect4", c4_replay)):
        cfg = buf.config
        games = [buf.buffer[k] for k in sorted(buf.buffer)]
        capacity = min(int(cfg.replay_buffer_size), len(games))
        (card, card_s), (cpu, cpu_s) = ring_pair(cfg, games, capacity)
        scale = float(cpu.root_values.abs().max()) + float(cpu.rewards.abs().sum(1).max())
        errs = {name: ring_close(f"15d {label} ring", name, getattr(card, name),
                                 getattr(cpu, name), scale) for name in dr.DeviceReplay._fields}
        gen = torch.Generator().manual_seed(5)
        B, U, A = cfg.batch_size, cfg.num_unroll_steps, len(cfg.action_space)
        slots, pos, _, _ = dr.sample_indices(cpu, gen, B, use_per=bool(cfg.PER))
        draws = {"slots": slots, "pos": pos,
                 "fill_actions": torch.randint(0, A, (B, U + 1), generator=gen)}
        kw = dict(num_unroll_steps=U, td_steps=cfg.td_steps, discount=cfg.discount,
                  num_actions=A, num_stacked=cfg.stacked_observations, use_per=bool(cfg.PER))
        batches = [dr.get_batch(ring, None, B, draws={k: v.to(dev) for k, v in draws.items()},
                                **kw) for ring, dev in ((card, "cuda"), (cpu, "cpu"))]
        (ib_card, b_card), (ib_cpu, b_cpu) = batches
        if not torch.equal(ib_card.cpu(), ib_cpu):
            fail(f"15d {label}: index batches differ")
        berrs = {k: ring_close(f"15d {label} batch", k, b_card[k], b_cpu[k], scale)
                 for k in b_cpu}
        log(f"[device replay {label}] {len(games)} games of phase {'3d' if label == 'cartpole' else '4b'} "
            f"into rings of {capacity} (max_moves {cfg.max_moves}): save_games card "
            f"{card_s * 1e3:.1f} ms, CPU {cpu_s * 1e3:.1f} ms; ring card vs CPU: every field "
            f"equal but priorities {errs['priorities']:.3g}, game priorities "
            f"{errs['game_priority']:.3g}; batch {B} x {U + 1} on forced draws: equal but "
            f"values {berrs['target_value']:.3g}, IS weights {berrs['weight']:.3g} (bound "
            f"{RING_ULPS} ulps of {max(1.0, scale):.4g})")

    # One device train round at M = 8 from the shipped cartpole checkpoint and
    # its Adam state, on forced draws.
    cfg = cart_replay.config
    games = [cart_replay.buffer[k] for k in sorted(cart_replay.buffer)]
    (card_ring, _), (cpu_ring, _) = ring_pair(cfg, games, int(cfg.replay_buffer_size))
    card_l, cpu_l = learner_pair(cfg, CART_CHECKPOINT)
    M, B, U, A = 8, cfg.batch_size, cfg.num_unroll_steps, len(cfg.action_space)
    gen = torch.Generator().manual_seed(8)
    draws = []
    for _ in range(M):
        slots, pos, _, _ = dr.sample_indices(cpu_ring, gen, B)
        draws.append({"slots": slots, "pos": pos,
                      "fill_actions": torch.randint(0, A, (B, U + 1), generator=gen)})
    targets = [dr.get_batch(cpu_ring, None, B, draws=d, num_unroll_steps=U,
                            td_steps=cfg.td_steps, discount=cfg.discount, num_actions=A,
                            num_stacked=cfg.stacked_observations)[1]["target_value"]
               for d in draws]
    scale = max(float(t.abs().max()) for t in targets)
    copies = {"n": 0}
    on_device = Learner._on_device

    def counted(self, batch):
        copies["n"] += 1
        return on_device(self, batch)

    Learner._on_device = counted
    try:
        t0 = time.perf_counter()
        m_cpu = dr.make_device_train(cpu_l, cfg, M)(cpu_ring, None, draws=draws)
        cpu_s = time.perf_counter() - t0
        card_draws = [{k: v.to("cuda") for k, v in d.items()} for d in draws]
        round_fn = dr.make_device_train(card_l, cfg, M)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m_card = round_fn(card_ring, None, draws=card_draws)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    finally:
        Learner._on_device = on_device
    if copies["n"]:
        fail(f"15d: the device train round copied {copies['n']} batches from the host")
    tol = LEARN_F32
    loss_err = 0.0
    for key in ("total_loss", "value_loss", "reward_loss", "policy_loss"):
        got, want = float(m_card[key]), float(m_cpu[key])
        if not abs(got - want) <= tol["loss_rtol"] * abs(want):
            fail(f"15d device train: {key} {got!r} on the card, {want!r} on the CPU")
        loss_err = max(loss_err, abs(got - want) / abs(want))
    alpha = cfg.PER_alpha
    gap = (card_ring.priorities.cpu().double() ** (1 / alpha)
           - cpu_ring.priorities.double() ** (1 / alpha)).abs()
    if float(gap.max()) > tol["gap_tol"] * max(scale, 1.0):
        fail(f"15d device train: ring priorities' |value - target| differ by "
             f"{float(gap.max())!r}")
    worst, _ = compare_learner_states("15d device train", card_l, cpu_l, tol["stats_tol"],
                                      tol["close"], moments=True)
    log(f"[device replay train] make_device_train at M = {M}, batch {B}, unroll {U}, from the "
        f"shipped cartpole checkpoint and Adam state, forced draws: card {card_s * 1e3:.1f} ms "
        f"(host clock, first call), CPU {cpu_s:.2f} s; losses within {loss_err:.3g} relative "
        f"(bound {tol['loss_rtol']}), "
        f"ring priorities' |value - target| within {float(gap.max()):.3g} (bound "
        f"{tol['gap_tol']} x {max(scale, 1.0):.4g}), params within {worst:.3g}, Adam moments "
        f"as the CPU's; 0 batches copied from the host")
    log(f"[done] 15d after {time.perf_counter() - t_phase:.1f} s of the phase")

    # ---- 15e. train() with device replay at the shipped width -----------------
    import shutil

    root = REPO / "results" / "chip_smoke" / "device_replay"
    shutil.rmtree(root, ignore_errors=True)
    mz = MuZero("cartpole", {"training_steps": CART_TRAIN_STEPS, "device_replay": True,
                             "results_path": str(root)})
    if int(mz.config.fused_train_steps) != 8 or mz.config.parallel_games != 16:
        fail("15e: not cartpole's shipped config")
    counts = {"round_copies": 0, "single": 0, "rounds": 0, "sweeps": 0, "mirrored": 0}
    in_round = {"on": False}
    train_step, train_round = Learner.train_step, muzero_lib.DeviceRing.train_round
    on_reanalysed = muzero_lib.DeviceRing.on_reanalysed
    sweep = muzero_lib.MuZero._reanalyse_sweep

    def counted_copy(self, batch):
        if in_round["on"]:
            counts["round_copies"] += 1
        return on_device(self, batch)

    def counted_single(self, batch):
        counts["single"] += 1
        return train_step(self, batch)

    def counted_round(self):
        counts["rounds"] += 1
        in_round["on"] = True
        try:
            return train_round(self)
        finally:
            in_round["on"] = False

    def counted_mirror(self, game_id, values):
        counts["mirrored"] += 1
        return on_reanalysed(self, game_id, values)

    def counted_sweep(self, *args, on_update=None, **kwargs):
        if on_update is not None:
            counts["sweeps"] += 1
        return sweep(self, *args, on_update=on_update, **kwargs)

    Learner._on_device, Learner.train_step = counted_copy, counted_single
    muzero_lib.DeviceRing.train_round = counted_round
    muzero_lib.DeviceRing.on_reanalysed = counted_mirror
    muzero_lib.MuZero._reanalyse_sweep = counted_sweep
    mcts_fused.search.launches = 0
    try:
        ck, train_s = timed_train(mz)
    finally:
        Learner._on_device, Learner.train_step = on_device, train_step
        muzero_lib.DeviceRing.train_round = train_round
        muzero_lib.DeviceRing.on_reanalysed = on_reanalysed
        muzero_lib.MuZero._reanalyse_sweep = sweep
    launches = mcts_fused.search.launches
    ring = mz.device_ring
    if (ck["training_step"] != CART_TRAIN_STEPS or ring is None or not counts["rounds"]
            or launches == 0 or counts["round_copies"]):
        fail(f"15e: train() ended at {ck['training_step']}, ring {ring is not None}, counts "
             f"{counts}, fused-search launches {launches}")
    if counts["rounds"] * 8 + counts["single"] != CART_TRAIN_STEPS:
        fail(f"15e: {counts['rounds']} device rounds and {counts['single']} host steps for "
             f"{CART_TRAIN_STEPS} steps")
    state = ring.state
    if int(state.num_played_games) != ck["num_played_games"]:
        fail(f"15e: the ring holds {int(state.num_played_games)} games, the host buffer "
             f"{ck['num_played_games']}")
    if not all(np.isfinite(ck[k]) for k in ("total_loss", "value_loss", "policy_loss")):
        fail("15e: non-finite losses")
    if ck["num_reanalysed_games"] and not counts["mirrored"]:
        fail("15e: reanalyse refreshed games but none reached the ring")
    next(k for k in kernels if k["name"] == "mcts_fused_search")[
        "cartpole_device_replay_train_launches"] = launches
    pt = mz.phase_time
    log(f"[muzero cartpole device replay] train() {CART_TRAIN_STEPS} steps, device_replay on "
        f"(16 lanes x 50 sims, batch 128, unroll 10, M = 8) in {train_s:.2f} s: "
        f"{CART_TRAIN_STEPS / train_s:.3f} train "
        f"steps/s (13a's host replay in this run: {CART_TRAIN_STEPS / host_train_s:.3f}), "
        f"{ck['num_played_steps'] / train_s:.1f} env-steps/s; {counts['rounds']} device rounds "
        f"of 8 steps, {counts['single']} single host steps (the remainders below M, as in "
        f"JAX); host-to-card batch copies in the device rounds: {counts['round_copies']}; "
        f"reanalyse: {counts['sweeps']} sweeps, {counts['mirrored']} games mirrored into the "
        f"ring ({ck['num_reanalysed_games']} refreshed); the ring holds "
        f"{int((state.game_len > 0).sum())} games, {int(state.total_samples)} positions; "
        f"fused-search launches {launches}; batch phase {pt['batch']:.4f} s")
    log(f"[muzero cartpole device replay] phase split: {phase_split(pt, train_s)}")
    seconds = time.perf_counter() - t_phase
    log(f"[done] 15d-15e in {seconds:.1f} s")
    return seconds


# ---------------------------------------------------------------------------
# The host-env path (hostplay.py) on numpy stand-ins of the host games, and
# the hyperparameter search (search.py)
# ---------------------------------------------------------------------------

# Phase 16d's lanes: atari's shipped parallel_games.
ATARI_LANES = 350
# The stand-in lander's episodes end after this many moves, so that 16b's
# train() completes games within its first chunks and its two test() games,
# B = 1 searches on the plain-op route (~14 ms a simulation, host-bound),
# end within ~10 s each (20 moves before phase 18, a depth cut).
LANDER_EPISODE = 10


def host_stand_ins():
    """Numpy stand-ins with the host games' shapes, their dynamics drawn
    from seeded numpy generators (this machine has no gymnasium, cv2,
    ale-py or pyspiel): (lunarlander's env, a pyspiel-surface tic-tac-toe
    game for SpielGame(game=...), an ALE-shaped frame env)."""
    import numpy as np

    from muzero_general_tpu_torch.envs.host import HostEnv

    class Lander(HostEnv):
        """(1, 1, 8) observations, 4 actions, episodes of LANDER_EPISODE moves."""

        observation_shape = (1, 1, 8)
        num_actions = 4

        def __init__(self, seed=None):
            self.rng = np.random.default_rng(seed)

        def reset(self):
            self.state, self.t = self.rng.uniform(-1, 1, 8).astype(np.float32), 0
            return self.state.reshape(1, 1, 8).copy()

        def step(self, action):
            push = np.zeros(8, np.float32)
            push[2 * int(action)] = 0.1
            self.state = (0.9 * self.state + push
                          + 0.05 * self.rng.standard_normal(8)).astype(np.float32)
            self.t += 1
            reward = float(-np.abs(self.state[:2]).sum() / 3)
            return self.state.reshape(1, 1, 8).copy(), reward, self.t >= LANDER_EPISODE

    class TicTacToeState:
        """pyspiel.State surface: tic-tac-toe, observation planes (empty,
        player 0, player 1) of 3 x 3."""

        def __init__(self):
            self.board, self.player, self.winner = np.zeros(9, np.int64), 0, None

        def current_player(self):
            return -4 if self.is_terminal() else self.player  # pyspiel's kTerminal

        def observation_tensor(self, player):
            return np.stack([self.board == k for k in (0, 1, 2)]).astype(np.float32).ravel()

        def legal_actions(self):
            return [] if self.is_terminal() else [int(a) for a in np.flatnonzero(self.board == 0)]

        def apply_action(self, action):
            self.board[action] = self.player + 1
            b = self.board.reshape(3, 3) == self.player + 1
            if b.all(0).any() or b.all(1).any() or b.trace() == 3 or np.fliplr(b).trace() == 3:
                self.winner = self.player
            self.player ^= 1

        def is_terminal(self):
            return self.winner is not None or bool((self.board != 0).all())

        def player_return(self, player):
            return 0.0 if self.winner is None else (1.0 if self.winner == player else -1.0)

    class TicTacToe:
        """pyspiel.Game surface, tic_tac_toe's shapes."""

        def observation_tensor_shape(self):
            return [3, 3, 3]

        def policy_tensor_shape(self):
            return [9]

        def num_players(self):
            return 2

        def max_game_length(self):
            return 9

        def new_initial_state(self):
            return TicTacToeState()

    class Frames(HostEnv):
        """ALE Breakout's preprocessed shape (3, 96, 96), 4 actions: each
        frame a seeded random image, episodes of 27,000 moves at most."""

        observation_shape = (3, 96, 96)
        num_actions = 4

        def __init__(self, seed=None):
            self.rng = np.random.default_rng(seed)

        def reset(self):
            self.t = 0
            return self.rng.random((3, 96, 96), dtype=np.float32)

        def step(self, action):
            self.t += 1
            return (self.rng.random((3, 96, 96), dtype=np.float32),
                    float(self.rng.random() < 0.05), self.t >= 27000)

    return Lander, TicTacToe, Frames


def host_profile(label, driver, move_ms, dispatches):
    """One move of the host driver under torch.profiler: launches per
    simulation (of one dispatch's search) and the card's busy share of an
    unprofiled move (`move_ms`)."""
    rows, wall_ms, _ = device_trace(lambda: driver.play(1.0, num_moves=1))
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[2] for r in rows)
    if busy_ms <= 0:
        log(f"[profile {label}] one move: {wall_ms:.2f} ms wall (profiled); device time: not "
            "measured (the trace holds none)")
        return None
    per_sim = launches / (dispatches * driver.spec.num_simulations)
    share = 100 * busy_ms / move_ms
    log(f"[profile {label}] one move: {busy_ms:.3f} ms of device kernels, {launches} launches "
        f"({per_sim:.1f} per simulation of a dispatch, {dispatches} dispatch(es) a move); "
        f"{wall_ms:.2f} ms wall profiled; of an unprofiled move ({move_ms:.3f} ms) the card is "
        f"busy {share:.1f}%, idle {100 - share:.1f}%")
    for dev_us, key, count in sorted(rows, reverse=True)[:5]:
        log(f"[profile {label}]   {dev_us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")
    return share


def host_path_phase(kernels):
    """Phase 16: the host driver on the stand-ins (lunarlander, spiel,
    atari), MuZero's host branches, and the hyperparameter search. Adds
    each sub-phase's launches to the kernels' entries."""
    import shutil
    import threading

    import numpy as np

    from muzero_general_tpu_torch import MuZero, search
    from muzero_general_tpu_torch.envs.host import SpielGame
    from muzero_general_tpu_torch.games import atari, lunarlander, spiel
    from muzero_general_tpu_torch.hostplay import HostSelfPlayDriver
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.ops import mcts_fused, mcts_kernels

    t_phase = time.perf_counter()
    root = REPO / "results" / "chip_smoke" / "host"
    shutil.rmtree(root, ignore_errors=True)
    entries = {k["name"]: k for k in kernels}
    Lander, TicTacToe, Frames = host_stand_ins()
    tree_kernels = ("descend_planar", "backprop")

    def zero_counts():
        mcts_fused.search.launches = 0
        mcts_kernels.descend_planar.launches = 0
        mcts_kernels.backprop.launches = 0

    def counts():
        return {"mcts_fused_search": mcts_fused.search.launches,
                "descend_planar": mcts_kernels.descend_planar.launches,
                "backprop": mcts_kernels.backprop.launches}

    def add_launches(key, launched):
        for name, n in launched.items():
            if n:
                entries[name][key] = entries[name].get(key, 0) + n

    def checked_moves(label, driver, moves):
        """`moves` moves with every kernel launch held against its plain
        version; fail unless each tree kernel ran once per simulation of
        each dispatch. Returns ({kernel: launches}, the completed games)."""
        with CheckedLaunches(label) as checked:
            games, stats = driver.play(1.0, num_moves=moves)
        done = checked.checked()
        launched = {name: checked.launches()[name] for name in tree_kernels}
        dispatches = 2 if driver.pipelined else 1
        want = moves * dispatches * driver.spec.num_simulations
        if set(done) != set(tree_kernels) or any(n != want for n in launched.values()):
            fail(f"{label}: launches {launched} (want {want} each), checked {sorted(done)}")
        log(f"[{label}] {moves} move(s), {driver.G} lanes x {driver.spec.num_simulations} sims "
            f"({dispatches} dispatch(es) of {driver.search_batch} lanes a move): every launch "
            "against its plain version: " + ", ".join(
                f"{name} {n} launches equal (max |d| {e!r})" for name, (n, e) in done.items()))
        return launched, games + stats["eval_games"]

    def timed_chunks(driver, reps):
        """`reps` play() chunks after zeroed counts: (s per chunk, stats,
        launches)."""
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            games, stats = driver.play(1.0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps, stats, {n: counts()[n] for n in tree_kernels}

    # ---- 16a. lunarlander's shipped width, pipeline off and on ----------------
    rates = {}
    for pipelined in (False, True):
        cfg = lunarlander.MuZeroConfig()
        cfg.host_pipeline = pipelined
        mode = "pipelined" if pipelined else "serial"
        net = MuZeroNetwork(cfg, seed=0)
        driver = HostSelfPlayDriver(Lander, net, cfg, seed=0)
        G, K, S = driver.G, cfg.selfplay_chunk_moves, cfg.num_simulations
        if (G, K, S, cfg.encoding_size, cfg.fc_dynamics_layers) != (16, 8, 50, 10, [64]):
            fail(f"16a: not lunarlander's shipped config: {(G, K, S)}")
        if not driver.spec.use_kernels or driver.search_batch != (8 if pipelined else 16):
            fail(f"16a {mode}: kernels {driver.spec.use_kernels}, batch {driver.search_batch}")
        first, _ = checked_moves(f"lunarlander host {mode}", driver, 1)
        reps = 1  # timed chunks (2 before phase 18)
        chunk_s, stats, launched = timed_chunks(driver, reps)
        dispatches = 2 if pipelined else 1
        if any(n != reps * K * dispatches * S for n in launched.values()):
            fail(f"16a {mode}: launches {launched} over {reps * K} moves")
        add_launches(f"lunarlander_host_{mode}_launches",
                     {n: first[n] + launched[n] for n in tree_kernels})
        move_ms = chunk_s * 1e3 / K
        rates[mode] = stats["env_steps"] / chunk_s
        log(f"[lunarlander host {mode}] HostSelfPlayDriver.play, shipped width (FC, encoding "
            f"10, 64-wide, support 10), {G} lanes x {S} sims, {K} moves a chunk, stand-in env: "
            f"{chunk_s * 1e3:.2f} ms/chunk, {move_ms:.3f} ms/move, {rates[mode]:.1f} "
            f"env-steps/s; launches {launched} over {reps * K} moves "
            f"({launched['descend_planar'] / (reps * K * dispatches):.1f} a dispatch)")
        host_profile(f"lunarlander host {mode}", driver, move_ms, dispatches)
    log(f"[lunarlander host] env-steps/s pipelined {rates['pipelined']:.1f} against serial "
        f"{rates['serial']:.1f} ({rates['pipelined'] / rates['serial']:.3f}x)")
    log(f"[done] 16a after {time.perf_counter() - t_phase:.1f} s of the phase")

    # ---- 16b. MuZero("lunarlander").train() and test() ------------------------
    mz = MuZero("lunarlander", {"training_steps": 16, "results_path": str(root / "lunarlander")})
    mz.make_env = lambda seed=None, **kw: Lander(seed)
    zero_counts()
    ck, train_s = timed_train(mz)
    train_launches = {n: counts()[n] for n in tree_kernels}
    if ck["training_step"] != 16 or not all(train_launches.values()):
        fail(f"16b: train() ended at {ck['training_step']} with launches {train_launches}")
    if not all(np.isfinite(ck[k]) for k in ("total_loss", "value_loss", "policy_loss")):
        fail("16b: non-finite losses")
    add_launches("lunarlander_host_train_launches", train_launches)
    log(f"[muzero lunarlander host] train() 16 steps at the shipped width on the stand-in "
        f"env in {train_s:.2f} s: {ck['num_played_games']} games, {ck['num_played_steps']} "
        f"steps, launches {train_launches}; loss {ck['total_loss']:.4f}; last greedy reward "
        f"{ck['total_reward']:.3f}")
    log(f"[muzero lunarlander host] phase split: {phase_split(mz.phase_time, train_s)}")
    results = {}
    for opponent in ("self", "random"):
        zero_counts()
        t0 = time.perf_counter()
        results[opponent] = mz.test(opponent=opponent, num_tests=1)
        test_s = time.perf_counter() - t0
        launched = {n: counts()[n] for n in tree_kernels}
        if not np.isfinite(results[opponent]):
            fail(f"16b: test(opponent={opponent!r}) gave {results[opponent]}")
        add_launches(f"lunarlander_host_test_{opponent}_launches", launched)
        how = ("the host driver at G = 1" if opponent == "self"
               else "play_against_opponent's host branch, B = 1")
        log(f"[muzero lunarlander host] test(opponent={opponent!r}): reward "
            f"{results[opponent]:.3f} in {test_s:.2f} s through {how}; launches {launched}")
    log(f"[done] 16b after {time.perf_counter() - t_phase:.1f} s of the phase")

    # ---- 16c. spiel: the two-player ResNet on a tic-tac-toe stand-in ----------
    cfg = spiel.MuZeroConfig()
    if (tuple(cfg.observation_shape), len(cfg.action_space), len(cfg.players)) != ((3, 3, 3), 9, 2):
        fail(f"16c: spiel's config {cfg.observation_shape} without pyspiel")
    net = MuZeroNetwork(cfg, seed=0)
    driver = HostSelfPlayDriver(lambda seed=None: SpielGame(game=TicTacToe()), net, cfg, seed=0)
    if not (driver.fold_bn and driver.spec.use_kernels):
        fail(f"16c: fold {driver.fold_bn}, kernels {driver.spec.use_kernels}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launched, games = checked_moves("spiel host", driver, cfg.selfplay_chunk_moves)
    chunk_s = time.perf_counter() - t0
    add_launches("spiel_host_launches", launched)
    outcomes = [float(gh.rewards[-1]) for gh in games]
    if not games or any(gh.child_visits.shape[1:] != (9,) for gh in games):
        fail(f"16c: {len(games)} completed games")
    log(f"[spiel host] one chunk of {cfg.selfplay_chunk_moves} moves, {driver.G} lanes x "
        f"{cfg.num_simulations} sims, {cfg.blocks} x {cfg.channels} ResNet (BN folded), with "
        f"every launch checked: {chunk_s:.2f} s; {len(games)} tic-tac-toe games completed, "
        f"{outcomes.count(1.0)} won by the last mover, {outcomes.count(0.0)} drawn")

    # ---- 16d. atari's network at the shipped width ---------------------------
    cfg = atari.MuZeroConfig()
    width = (cfg.blocks, cfg.channels, cfg.stacked_observations, cfg.support_size,
             cfg.compute_dtype, cfg.downsample, cfg.parallel_games, cfg.num_simulations)
    if width != (16, 256, 32, 300, "bfloat16", "resnet", ATARI_LANES, 50):
        fail(f"16d: not atari's shipped config: {width}")
    t0 = time.perf_counter()
    net = MuZeroNetwork(cfg, seed=0)
    driver = HostSelfPlayDriver(Frames, net, cfg, seed=0)
    setup_s = time.perf_counter() - t0
    if not (driver.fold_bn and driver.spec.use_kernels):
        fail(f"16d: fold {driver.fold_bn}, kernels {driver.spec.use_kernels}")
    t0 = time.perf_counter()
    first, _ = checked_moves("atari host", driver, 1)
    checked_s = time.perf_counter() - t0
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = driver.play(1.0, num_moves=1)
    torch.cuda.synchronize()
    move_ms = (time.perf_counter() - t0) * 1e3
    launched = {n: counts()[n] for n in tree_kernels}
    if any(n != cfg.num_simulations for n in launched.values()):
        fail(f"16d: launches {launched} in one move")
    if not np.isfinite(stats["pred_values"]).all():
        fail("16d: non-finite values")
    add_launches("atari_host_launches", {n: first[n] + launched[n] for n in tree_kernels})
    log(f"[atari host] the shipped network (downsample resnet, 16 blocks x 256 channels, 32 "
        f"stacked frames: {3 * 33 + 32} input planes of 96 x 96, support 300, bf16), "
        f"{driver.G} lanes x {cfg.num_simulations} sims, stand-in frames: set-up "
        f"{setup_s:.2f} s, the checked move {checked_s:.2f} s, a timed move {move_ms:.1f} ms "
        f"({driver.G / move_ms * 1e3:.1f} env-steps/s), launches {launched}; max depth "
        f"{stats['max_tree_depth']}")
    host_profile("atari host", driver, move_ms, 1)
    del driver, net
    torch.cuda.empty_cache()
    log(f"[done] 16c-16d after {time.perf_counter() - t_phase:.1f} s of the phase")

    # ---- 16e. the hyperparameter search ---------------------------------------
    tiny = {"training_steps": 16, "max_moves": 100}
    runs = []
    run_candidate = search._run_candidate

    def recorded(game, values, overrides, devices, num_tests, path):
        out = run_candidate(game, values, overrides, devices, num_tests, path)
        runs.append((values, devices, out[0], threading.current_thread().name))
        return out

    search._run_candidate = recorded
    zero_counts()
    t0 = time.perf_counter()
    try:
        best = search.one_plus_one_search(
            "cartpole", {"lr_init": ("log", 1e-3, 1e-1)}, budget=2, parallel_experiments=2,
            num_tests=1, base_overrides=tiny, results_root=root / "search")
    finally:
        search._run_candidate = run_candidate
    search_s = time.perf_counter() - t0
    fused = counts()["mcts_fused_search"]
    threads = {name for *_, name in runs}
    if (len(runs) != 2 or threads != {threading.main_thread().name} or best is None
            or not (root / "search" / "model.checkpoint").exists() or not fused):
        fail(f"16e: runs {runs}, best {best}, fused-search launches {fused}")
    entries["mcts_fused_search"]["hyperparameter_search_launches"] = fused
    log(f"[search] one_plus_one_search('cartpole', budget 2, parallel_experiments 2, "
        f"candidates of {tiny}) in {search_s:.2f} s, on slices {[str(d) for _, d, _, _ in runs]}"
        f" (one card: they collide, so one after the other): " + "; ".join(
            f"lr_init {v['lr_init']:.5f} -> score {s:.2f}" for v, _, s, _ in runs)
        + f"; best {best}; fused-search launches {fused}")
    seconds = time.perf_counter() - t_phase
    log(f"[done] phase 16 in {seconds:.1f} s")
    return seconds


# ---------------------------------------------------------------------------
# 17. The mesh (parallel/): two ranks on the card
# ---------------------------------------------------------------------------

# Two ranks share cuda:0. NCCL refuses two ranks on one card, so the port
# picks gloo for them (17a-f: from the cards' UUIDs at the rendezvous; 17g
# names it in its spec), which stages the collectives' CUDA tensors through
# the host; the compute stays on the card.
MESH_DEVICES = ["cuda:0", "cuda:0"]
MESH_BACKEND = "gloo"
# A sharded SGD step (no momentum: the update is linear in the gradient)
# against the single-rank step on the same global batch, at
# tests/test_sharding.py's tolerances: loss 1e-5 relative, priorities rtol
# 1e-4 atol 1e-5, updates rtol 5e-3 atol 1e-6. The ResNet (Adam, whose
# first update is ~lr * sign(g)) keeps phase 12's rule (LEARN_F32: losses
# 1e-4 relative, the priorities' |value - target| within 1e-4 of the
# largest |target|, >= 99% of params within 1e-5, the running statistics'
# tolerance), twice: from seed 0's weights with a fresh Adam state, where
# every train() starts, and from the shipped checkpoint and its Adam state.
# From seed 0 the unroll is cut from 42 to MESH_SEED0_UNROLL steps: past
# ~10 the step from random weights is so ill-conditioned that one rank's
# own float32 step misses the float64 step by more than LEARN_F32 allows
# (tools/float64_check.py --cases seed0_unroll: at 42, 6.7e-4 in the loss,
# |value - target| 3.35 apart, 35% of params beyond 1e-5), so no two float32
# steps there can be held to it; at 5 one rank's lands well inside it.
MESH_LOSS_REL, MESH_PRIO, MESH_UPDATE = 1e-5, (1e-4, 1e-5), (5e-3, 1e-6)
MESH_SEED0_UNROLL = 5
MESH_TRAIN_STEPS = 50


def mesh_batch(cfg, seed):
    """A seeded global batch at the config's shapes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    B, U = cfg.batch_size, cfg.num_unroll_steps
    A = len(cfg.action_space)
    c, h, w = cfg.observation_shape
    n = cfg.stacked_observations
    return {
        "observation": rng.normal(size=(B, c * (n + 1) + n, h, w)).astype(np.float32),
        "action": rng.integers(0, A, (B, U + 1)).astype(np.int32),
        "target_value": (3 * rng.normal(size=(B, U + 1))).astype(np.float32),
        "target_reward": rng.normal(size=(B, U + 1)).astype(np.float32),
        "target_policy": rng.dirichlet(np.ones(A), (B, U + 1)).astype(np.float32),
        "weight": rng.uniform(0.2, 1.0, B).astype(np.float32),
        "gradient_scale": rng.integers(1, U + 1, (B, U + 1)).astype(np.float32),
    }


def mesh_step_configs():
    """(a) cartpole's FC net, (b) connect4's ResNet from seed 0 and from
    the shipped checkpoint, (c) the 512-wide FC net of
    tests/test_sharding.py on cartpole's shapes: (key, label, config, mesh
    shape, the checkpoint to start from or None for seed 0's weights, the
    rule: "sgd" for test_sharding.py's, "resnet" for LEARN_F32)."""
    from muzero_general_tpu_torch.games import cartpole, connect4

    def sgd(cfg):
        cfg.optimizer, cfg.momentum, cfg.weight_decay = "SGD", 0.0, 0.0
        return cfg

    wide = sgd(cartpole.MuZeroConfig())
    wide.encoding_size = 512
    wide.fc_representation_layers = wide.fc_dynamics_layers = [512]
    seed0 = connect4.MuZeroConfig()
    seed0.num_unroll_steps = MESH_SEED0_UNROLL
    return [("a", "cartpole FC", sgd(cartpole.MuZeroConfig()), (2, 1), None, "sgd"),
            ("b seed 0", f"connect4 ResNet from seed 0, unroll {MESH_SEED0_UNROLL}", seed0,
             (2, 1), None, "resnet"),
            ("b checkpoint", "connect4 ResNet from the checkpoint", connect4.MuZeroConfig(),
             (2, 1), C4_CHECKPOINT, "resnet"),
            ("c", "512-wide FC", wide, (1, 2), None, "sgd")]


def state_digest(state):
    import hashlib

    h = hashlib.sha256()
    for name in sorted(state):
        h.update(name.encode())
        h.update(state[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def mesh_step_case(label, cfg, shape, checkpoint, rule, seed, timed):
    """On a rank: one sharded step from seed 0's weights (or `checkpoint`'s,
    with its optimizer state) on this rank's rows of a seeded global batch,
    and on rank 0 the single-rank step on the whole batch, compared under
    `rule` (fail on a mismatch); then, if `timed`, the sharded step's and
    the single step's times and the gradient all_reduce's. Returns the
    numbers."""
    import numpy as np

    from muzero_general_tpu_torch.checkpoint import load_checkpoint, restore_learner

    from muzero_general_tpu_torch.parallel import (
        create_mesh,
        make_sharded_train_step,
        shard_batch,
    )
    from muzero_general_tpu_torch.parallel import distributed as dist_lib
    from muzero_general_tpu_torch.parallel.mesh import all_reduce_flat
    from muzero_general_tpu_torch.trainer import Learner

    def learner():
        out = Learner(cfg, seed=0)
        if checkpoint is not None:
            restore_learner(out, load_checkpoint(checkpoint))
        return out

    sgd = rule == "sgd"
    loss_rel = MESH_LOSS_REL if sgd else LEARN_F32["loss_rtol"]
    mesh = create_mesh(*shape)
    rank = mesh.rank
    batch = mesh_batch(cfg, seed)
    sharded = learner()
    before = {k: v.detach().cpu().clone() for k, v in sharded.network.state_dict().items()}
    local = shard_batch(batch, mesh)
    metrics, priorities = make_sharded_train_step(sharded, mesh)(local)
    full = sharded.full_state_dict()
    digests = dist_lib.gather_objects(state_digest(full))
    shards = dist_lib.gather_objects(priorities.cpu().numpy())
    out = {"shape": shape, "local_rows": int(local["action"].shape[0])}
    if rank == 0:
        if len(set(digests)) != 1:
            fail(f"17 {label}: the ranks' parameters differ after the step")
        single = learner()
        m1, p1 = single.train_step(batch)
        got_p = np.concatenate(shards[:: shape[1]])
        want_p = p1.cpu().numpy()
        loss, want_loss = float(metrics["total_loss"]), float(m1["total_loss"])
        names = dict(single.network.named_parameters())
        errors = []

        def gap(a, b):  # the priorities' largest |value - target| difference
            alpha = cfg.PER_alpha
            return float(np.abs(np.asarray(a, np.float64) ** (1 / alpha)
                                - np.asarray(b, np.float64) ** (1 / alpha)).max())

        def param_gaps(got, want):
            """(largest |got - want|, share beyond LEARN_F32's close) over
            the parameters."""
            worst, beyond, total = 0.0, 0, 0
            for key in names:
                d = (got[key].double().cpu() - want[key].double().cpu()).abs()
                worst = max(worst, float(d.max()))
                beyond += int((d > LEARN_F32["close"]).sum())
                total += d.numel()
            return worst, beyond / total

        if not abs(loss - want_loss) <= loss_rel * abs(want_loss):
            errors.append(f"loss {loss!r} sharded, {want_loss!r} on one rank")
        if sgd and not np.allclose(got_p, want_p, rtol=MESH_PRIO[0], atol=MESH_PRIO[1]):
            errors.append(f"priorities differ by {np.abs(got_p - want_p).max()!r}")
        bound = LEARN_F32["gap_tol"] * max(float(np.abs(batch["target_value"]).max()), 1.0)
        if not sgd and not gap(got_p, want_p) <= bound:
            # phase 12's rule: |value - target| within gap_tol of max |target|
            errors.append(f"|value - target| differs by {gap(got_p, want_p)!r} (bound {bound!r})")
        ref = single.network.state_dict()
        for key, want in ref.items():
            got, want = full[key].double().cpu(), want.double().cpu()
            if key.endswith(("running_mean", "running_var")):
                tol = LEARN_F32["stats_tol"]
                if bool(((got - want).abs() > tol[0] + tol[1] * want.abs()).any()):
                    errors.append(f"{key} differs by {float((got - want).abs().max())!r}")
            elif sgd and key in names:
                d = ((got - before[key].double()) - (want - before[key].double())).abs()
                bound = MESH_UPDATE[1] + MESH_UPDATE[0] * (want - before[key].double()).abs()
                if bool((d > bound).any()):
                    errors.append(f"{key}'s update differs by {float(d.max())!r}")
        worst, beyond = param_gaps(full, ref)
        if not sgd and beyond > 0.01:
            errors.append(f"{100 * beyond:.3f}% of params beyond {LEARN_F32['close']}")
        out.update(loss=loss, loss_rel=abs(loss - want_loss) / abs(want_loss),
                   prio_err=float(np.abs(got_p - want_p).max()), param_err=worst,
                   beyond=beyond)
        if checkpoint is None and not sgd:
            # Seed 0's step against the exact one: the same step on one
            # rank in float64 (tools/float64_check.py's to_float64). How
            # far one rank's float32 step lands from it is the yardstick of
            # how far rounding alone carries this step.
            from muzero_general_tpu_torch.tools.float64_check import to_float64

            exact = to_float64(learner())
            m64, p64 = exact.train_step(batch)
            l64, p64 = float(m64["total_loss"]), p64.cpu().numpy()
            f64 = exact.network.state_dict()
            out["from_f64"] = {
                name: {"loss_rel": abs(value - l64) / abs(l64), "gap": gap(p, p64),
                       "param_err": param_gaps(state, f64)[0],
                       "beyond": param_gaps(state, f64)[1]}
                for name, value, p, state in (("sharded", loss, got_p, full),
                                              ("one_rank", want_loss, want_p, ref))}
        if errors:
            log(f"17 {label}: {json.dumps(out)}")
            fail(f"17 {label}: " + "; ".join(errors))
    # Times: the sharded step (both ranks at once), the single-rank step
    # (rank 0 alone, rank 1 waiting), the gradient all_reduce. The ResNet's
    # sharded step is timed once, after the compared step (~8 s: its batch
    # norms' collectives, ROADMAP).
    if not timed:
        return out
    step = make_sharded_train_step(sharded, mesh)
    reps = 5 if sgd else 1
    if sgd:
        step(local)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(local)
    torch.cuda.synchronize()
    out["sharded_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    torch.distributed.barrier()
    if rank == 0:
        single.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            single.train_step(batch)
        torch.cuda.synchronize()
        out["single_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    torch.distributed.barrier()
    group = mesh.dp_group if mesh.dp_group is not None else mesh.mp_group
    grads = torch.zeros(sum(p.numel() for p in sharded.network.parameters()), device="cuda")
    all_reduce_flat([grads], group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        all_reduce_flat([grads], group)
    torch.cuda.synchronize()
    out["all_reduce_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    out["grad_floats"] = grads.numel()
    return out


def zero_kernel_counts():
    from muzero_general_tpu_torch.ops import mcts_fused, mcts_kernels

    mcts_fused.search.launches = 0
    mcts_kernels.descend_planar.launches = 0
    mcts_kernels.backprop.launches = 0


def mesh_selfplay(label, module, lanes, sims, checkpoint, timed_moves):
    """On a rank: the dp = 2 driver of 2 x `lanes` lanes x `sims`
    simulations with the shipped weights: the first move with every launch
    of this rank held against its plain version, then `timed_moves` timed
    moves (ms a move on this rank, both ranks playing at once). Returns the
    numbers and this rank's launches."""
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.parallel import create_mesh
    from muzero_general_tpu_torch.parallel import distributed as dist_lib
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    mesh = create_mesh(2, 1)
    cfg = module.MuZeroConfig()
    cfg.parallel_games, cfg.num_simulations = 2 * lanes, sims
    net = load_pretrained(MuZeroNetwork(cfg, seed=0), checkpoint)
    driver = SelfPlayDriver(module.make_env(device=torch.device("cuda")), net, cfg, seed=0,
                            mesh=mesh)
    if (driver.lanes, driver.lane0) != (lanes, mesh.rank * lanes):
        fail(f"17e {label}: rank {mesh.rank} plays lanes {driver.lane0}+{driver.lanes}")
    names = (("mcts_fused_search",) if driver.search_route == "fused"
             else ("descend_planar", "backprop"))
    zero_kernel_counts()
    with CheckedLaunches(f"{label} rank {mesh.rank}") as checked:
        driver.play(1.0, num_moves=1)
    first = {n: checked.launches()[n] for n in names}
    done = checked.checked()
    want = 1 if driver.search_route == "fused" else sims
    if set(done) != set(names) or any(n != want for n in first.values()):
        fail(f"17e {label} rank {mesh.rank}: launches {first} (want {want}), checked {done}")
    zero_kernel_counts()
    torch.cuda.synchronize()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    _, stats = driver.play(1.0, num_moves=timed_moves)
    torch.cuda.synchronize()
    move_ms = (time.perf_counter() - t0) * 1e3 / timed_moves
    timed = {n: c for n, c in kernel_counts().items() if n in names}
    if any(c != timed_moves * want for c in timed.values()):
        fail(f"17e {label} rank {mesh.rank}: {timed} over {timed_moves} moves")
    steps = dist_lib.global_sum(driver.lanes * (1 + timed_moves))
    if steps != driver.G * (1 + timed_moves):
        fail(f"17f: global_sum of env steps {steps}, want {driver.G * (1 + timed_moves)}")
    return {"route": driver.search_route, "checked": done, "move_ms": move_ms,
            "launches": {n: first[n] + timed[n] for n in names}, "global_steps": steps,
            "env_steps_stat": stats["env_steps"]}


def mesh_rank():
    """One rank of phase 17a-f (dist_lib.launch)."""
    from muzero_general_tpu_torch.games import cartpole, connect4

    out = {"steps": {}, "backend": torch.distributed.get_backend()}
    if out["backend"] != MESH_BACKEND:
        fail(f"17: ranks sharing {MESH_DEVICES[0]} meet over {out['backend']}")
    for key, label, cfg, shape, checkpoint, rule in mesh_step_configs():
        out["steps"][key] = (label, mesh_step_case(label, cfg, shape, checkpoint, rule, seed=17,
                                                   timed=key != "b seed 0"))
    out["cartpole"] = mesh_selfplay("cartpole", cartpole, 2048, 50, CART_CHECKPOINT, 8)
    out["connect4"] = mesh_selfplay("connect4", connect4, 128, 200, C4_CHECKPOINT, 1)
    return out


def mesh_train_rank(rank, address, root):
    """One process of phase 17g: MuZero(..., distributed=...).train(). The
    phase hosts the rendezvous store (dist_lib.host_store)."""
    import os
    import pickle

    from muzero_general_tpu_torch import MuZero
    from muzero_general_tpu_torch.models import params_from_jax

    from muzero_general_tpu_torch.parallel import distributed as dist_lib

    os.environ[dist_lib.AGENT_STORE] = "True"
    path = pathlib.Path(root) / f"rank{rank}"
    mz = MuZero("cartpole", {"training_steps": MESH_TRAIN_STEPS, "results_path": str(path)},
                distributed={"coordinator_address": address, "num_processes": 2,
                             "process_id": rank, "local_device_ids": [0],
                             "backend": MESH_BACKEND})
    zero_kernel_counts()
    ckpt, train_s = timed_train(mz)
    weights = {k: v for k, v in params_from_jax(ckpt["weights"]).items()}
    out = {"training_step": ckpt["training_step"], "train_s": train_s,
           "digest": state_digest(weights), "files": sorted(p.name for p in path.iterdir()),
           "launches": kernel_counts()["mcts_fused_search"], "phase_time": mz.phase_time,
           "loss": ckpt["total_loss"], "played": ckpt["num_played_steps"],
           "backend": torch.distributed.get_backend(), "device": str(mz.device)}
    with open(pathlib.Path(root) / f"out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def mesh_phase(kernels):
    """Phase 17: the mesh (parallel/), two ranks sharing the card over gloo.
    Adds the ranks' launches to the kernels' entries."""
    import pickle
    import shutil

    import torch.multiprocessing as mp

    from muzero_general_tpu_torch.parallel import distributed as dist_lib

    t_phase = time.perf_counter()
    entries = {k["name"]: k for k in kernels}
    ranks = dist_lib.launch(mesh_rank, MESH_DEVICES)
    log(f"[mesh] 17a-f: {len(ranks)} ranks on {MESH_DEVICES[0]}, backend chosen "
        f"{ranks[0]['backend']} (ranks sharing a card), in "
        f"{time.perf_counter() - t_phase:.1f} s (spawn and imports included)")
    for key, (label, r0) in ranks[0]["steps"].items():
        r1 = ranks[1]["steps"][key][1]
        times = ("" if "sharded_ms" not in r0 else
                 f"; sharded step {r0['sharded_ms']:.3f} / {r1['sharded_ms']:.3f} ms (rank 0 / "
                 f"1) against one rank's {r0['single_ms']:.3f} ms; gradient all_reduce of "
                 f"{r0['grad_floats']} floats {r0['all_reduce_ms']:.3f} ms")
        log(f"[mesh step {key}] {label}, (dp, mp) = {r0['shape']}, {r0['local_rows']} rows a "
            f"rank: loss {r0['loss']!r} ({r0['loss_rel']:.3g} relative from one rank's), "
            f"priorities within {r0['prio_err']:.3g}, updates within {r0['param_err']:.3g} "
            f"({100 * r0['beyond']:.3f}% beyond {LEARN_F32['close']}); the ranks' parameters "
            f"bit-identical" + times)
        if "from_f64" in r0:
            log(f"[mesh step {key}] from the float64 step on one rank: " + "; ".join(
                f"{name} loss {d['loss_rel']:.3g} relative, |value - target| within "
                f"{d['gap']:.3g}, params within {d['param_err']:.3g} "
                f"({100 * d['beyond']:.3f}% beyond {LEARN_F32['close']})"
                for name, d in r0["from_f64"].items()))
    for game, lanes, sims in (("cartpole", 2048, 50), ("connect4", 128, 200)):
        for rank, r in enumerate(ranks):
            sp = r[game]
            log(f"[mesh selfplay {game}] rank {rank}: {lanes} lanes x {sims} sims "
                f"({sp['route']} route), first move's launches checked against the plain "
                f"versions: " + ", ".join(f"{n} {c} equal (max |d| {e!r})"
                                          for n, (c, e) in sp["checked"].items())
                + f"; {sp['move_ms']:.3f} ms a move with both ranks playing; launches "
                f"{sp['launches']}; global_sum of env steps {sp['global_steps']:.0f}")
        for name in ranks[0][game]["launches"]:
            entries[name][f"{name}_mesh_launches"] = [r[game]["launches"][name] for r in ranks]

    # ---- 17g. multi-host training: two processes, distributed=... ------------
    t0 = time.perf_counter()
    root = REPO / "results" / "chip_smoke" / "mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    store, address = dist_lib.host_store()
    mp.spawn(mesh_train_rank, args=(address, str(root)), nprocs=2, join=True)
    del store
    outs = []
    for rank in range(2):
        with open(root / f"out{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    if ([o["training_step"] for o in outs] != [MESH_TRAIN_STEPS] * 2
            or outs[0]["digest"] != outs[1]["digest"]
            or "model.checkpoint" not in outs[0]["files"] or outs[1]["files"]
            or not all(o["launches"] for o in outs)
            or {(o["backend"], o["device"]) for o in outs} != {("gloo", "cuda:0")}):
        fail(f"17g: {[{k: o[k] for k in ('training_step', 'files', 'launches', 'backend')} for o in outs]}")
    entries["mcts_fused_search"]["mcts_fused_search_mesh_train_launches"] = [
        o["launches"] for o in outs]
    for rank, o in enumerate(outs):
        log(f"[mesh train] rank {rank}: MuZero('cartpole', distributed=...).train() "
            f"{MESH_TRAIN_STEPS} steps in {o['train_s']:.2f} s "
            f"({MESH_TRAIN_STEPS / o['train_s']:.1f} steps/s), loss {o['loss']:.4f}, its own "
            f"{o['played']} env steps, fused-search launches {o['launches']}; files "
            f"{o['files']}; phase split {phase_split(o['phase_time'], o['train_s'])}")
    log(f"[mesh train] weights equal on both ranks (sha256 {outs[0]['digest'][:16]}); rank 1 "
        f"wrote nothing; 17g in {time.perf_counter() - t0:.1f} s with the spawn")
    seconds = time.perf_counter() - t_phase
    log(f"[done] phase 17 in {seconds:.1f} s")
    return seconds



# ---------------------------------------------------------------------------
# Phase 18: the port's tools (muzero_general_tpu_torch/tools/), in process
# ---------------------------------------------------------------------------

# The kernels line's key for a tool's launches of each kernel
TOOL_LAUNCH_KEYS = {"descend": "descend_node_major_tool_launches"}


def tools_phase(kernels):
    """Phase 18: gpu_parity, resnet_profile (connect4 64 x 50), hidden_store_bench
    (its shipped size), trace_search (a connect4 64 x 50 move on the kernel
    and on the plain-op route) and trace_train (cartpole, fused 2) through
    their entry points. Adds each tool's launches of each kernel to the
    kernel's entry under "<kernel>_tool_launches" (kernel 6's under
    "descend_node_major_tool_launches")."""
    import numpy as np

    from muzero_general_tpu_torch.tools import (gpu_parity, hidden_store_bench, profiling,
                                                resnet_profile, trace_search, trace_train)

    t_phase = time.perf_counter()
    entries = {k["name"]: k for k in kernels}
    by_kernel = {}

    def count(tool, launches):
        for name, n in launches.items():
            by_kernel.setdefault(name, {})[tool] = n

    def tagged(tag):
        return lambda msg: log(f"[{tag}] {msg}")

    # ---- 18a. gpu_parity: the kernels against the plain-op route ---------------
    before = profiling.launch_counts()
    lines = []
    rc = gpu_parity.main([], print_fn=lines.append)
    for line in lines:
        log(f"[tools gpu_parity] {line}")
    if rc != 0:
        fail(f"18a: gpu_parity exited {rc}")
    count("gpu_parity", profiling.launches_since(before))

    # ---- 18b. resnet_profile at connect4 64 x 50, kernel 6 checked --------------
    t0 = time.perf_counter()
    result = resnet_profile.run(resnet_profile.parse_args(["--games", "64", "--sims", "50"]),
                                log=tagged("tools resnet_profile"))
    if not result.get("descend_kernel_checked") or not result["launches"].get("descend"):
        fail(f"18b: resnet_profile's node-major descent: {result}")
    count("resnet_profile", result["launches"])
    log(f"[tools resnet_profile] {json.dumps(result)} ({time.perf_counter() - t0:.1f} s)")

    # ---- 18c. hidden_store_bench: three stores bit-equal ----------------------
    result = hidden_store_bench.run(hidden_store_bench.parse_args([]),
                                    print_fn=tagged("tools hidden_store_bench"))
    want = (1 + hidden_store_bench.REPS) * 200
    if not result["stores_equal"] or result["launches"] != want:
        fail(f"18c: hidden_store_bench stores equal {result['stores_equal']}, "
             f"{result['launches']} row-write launches (want {want})")
    count("hidden_store_bench", {"write_node_hidden": result["launches"]})

    # ---- 18d. trace_search: one connect4 move on each route ---------------------
    for pallas in ("1", "0"):
        tag = f"tools trace_search pallas={pallas}"
        result = trace_search.run(trace_search.parse_args(
            ["--games", "64", "--sims", "50", "--pallas", pallas, "--top", "8"]),
            print_fn=tagged(tag))
        want = {"descend_planar": 50, "backprop": 50} if pallas == "1" else {}
        if result["launches"] != want:
            fail(f"18d: trace_search (pallas={pallas}) launched {result['launches']}, want {want}")
        count(f"trace_search_pallas{pallas}", result["launches"])

    # ---- 18e. trace_train: cartpole's learner, fused 2 -------------------------
    result = trace_train.run(trace_train.parse_args(
        ["--game", "cartpole", "--batch", "128", "--fused", "2", "--top", "8"]),
        print_fn=tagged("tools trace_train"))
    if not np.isfinite(result["loss"]):
        fail(f"18e: trace_train's loss {result['loss']}")

    for name, tools in by_kernel.items():
        entries[name][TOOL_LAUNCH_KEYS.get(name, f"{name}_tool_launches")] = tools
    seconds = time.perf_counter() - t_phase
    log(f"[tools] launches by kernel and tool: {json.dumps(by_kernel)}")
    log(f"[done] phase 18 in {seconds:.1f} s")
    return seconds


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. the card ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] torch: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2.-11. ---------------------------------------------------------
    build_kernels()
    cart_replay, fused_entry = cartpole_path()
    kernels = [fused_entry]
    log(f"[done] cartpole path after {time.perf_counter() - t_start:.1f} s")
    entries, end_state, c4_replay, k1_conv_launches = connect4_path()
    kernels += entries
    log(f"[done] connect4 path after {time.perf_counter() - t_start:.1f} s")
    entries, k8_conv_launches = connect4_multileaf_path()
    kernels += entries
    log(f"[done] connect4 K=8 path after {time.perf_counter() - t_start:.1f} s")
    kernels.append(conv3x3_phase(k8_conv_launches, k1_conv_launches))
    log(f"[done] kernel 11 after {time.perf_counter() - t_start:.1f} s")
    kernels.append(node_major_descend_phase(*end_state))
    kernels.append(row_write_phase())
    log(f"[done] kernels 6 and 7 after {time.perf_counter() - t_start:.1f} s")
    kernels += gomoku_path()
    log(f"[done] gomoku path after {time.perf_counter() - t_start:.1f} s")
    kernels += conv_probe_phase()
    descend = next(k for k in kernels if k["name"] == "descend_stream")
    kernels.append(stream_probe_phase(descend["per_level_us"]))
    log(f"[done] probes after {time.perf_counter() - t_start:.1f} s")
    bf16_lanes()
    log(f"[done] bf16 lanes after {time.perf_counter() - t_start:.1f} s")
    fused_entry["learn_loop_launches"] = learner_phase(cart_replay, c4_replay)
    log(f"[done] learner after {time.perf_counter() - t_start:.1f} s")
    host_train = orchestration_phase(kernels)
    log(f"[done] orchestration after {time.perf_counter() - t_start:.1f} s")
    remaining_games_phase(kernels)
    log(f"[done] remaining games after {time.perf_counter() - t_start:.1f} s")
    gumbel_phase()
    device_replay_phase(cart_replay, c4_replay, kernels, host_train["train_s"])
    log(f"[done] Gumbel and device replay after {time.perf_counter() - t_start:.1f} s")
    host_path_phase(kernels)
    log(f"[done] host path after {time.perf_counter() - t_start:.1f} s")
    mesh_phase(kernels)
    log(f"[done] mesh after {time.perf_counter() - t_start:.1f} s")
    tools_phase(kernels)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
