"""The learner on the card against the CPU, each against a float64 step.

Two learner differences between the card and the CPU were seen and not
explained: the connect4 learner in bfloat16 (chip_smoke.py phase 12d) put
1.1% of its params beyond 1e-4 of the CPU's on one batch, and one float32
step of a small ResNet's device train round (tests/test_torch_gpu.py
test_device_train_round_on_the_card_matches_the_cpu[resnet-1]) moved 922 of
5,237 params by up to 1.29e-4. Either is a rounding tolerance if the card
lands as near the exact step as the CPU does, and a fault if it lands
farther. This tool rebuilds each case and runs the same step three ways from
the same weights, optimizer state and batch: on the card, on the CPU, and
on the CPU in float64 (every product, activation and optimizer moment in
float64: the step without rounding to speak of). It prints, for the card
and the CPU, the params' largest distance from the float64 step and the
share beyond `close`, and the card's distance from the CPU's.

1. connect4 (the shipped 3 x 64 ResNet and its Adam state, batch 64,
   unroll 42) in bfloat16 and in float32, on --batches replay batches of
   connect4 games that SelfPlayDriver plays on the card with the shipped net
   (256 lanes x 200 simulations, a warm-up and two 8-move chunks, as phase
   4b did in the run that saw the 1.1%), the first drawn as phase 12d draws
   it (the buffer's rng reseeded with 2), the others with seeds 3, 4, ...;
2. the device round: the ResNet (1 x 8 on 3 x 3 x 3, 9 actions, SGD) of
   the card test, its ring of seeded random games, its draws; the round
   (ops/device_replay.make_device_train, M = 1) on the card and on the CPU,
   and the float64 step on the batch the round draws;
3. seed0_unroll: connect4's 3 x 64 ResNet from seed 0's weights and a fresh
   Adam state, where every train() starts, on a seeded random batch of 64
   (chip_smoke.py's mesh_batch, seed 17), at unroll depths 3 to 42: one
   float32 step on the card against the float64 step on the card (the
   loss, the priorities' |value - target| and the params), and against
   itself run again. How far rounding alone carries this step at each
   depth is the yardstick for any two float32 steps from seed 0 (the
   mesh's phase 17b).

    python3 muzero_general_tpu_torch/tools/float64_check.py [--batches 3]
        [--cases device_round,connect4,seed0_unroll]

Prints the card's name and power limit, one line per case, then one JSON
line of every figure.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

C4_CHECKPOINT = REPO / "pretrained" / "connect4" / "model.checkpoint"


def to_float64(learner):
    """The learner's network, every layer's product and output, and its
    optimizer state in float64 (the parameters keep their objects, so the
    optimizer still holds them)."""
    from muzero_general_tpu_torch.models.common import Conv, Dense

    learner.network.double()
    for module in learner.network.modules():
        if isinstance(module, (Conv, Dense)):
            module.compute_dtype = module.out_dtype = torch.float64
    for state in learner.optimizer.state.values():
        for key, value in state.items():
            if key != "step" and torch.is_tensor(value) and value.is_floating_point():
                state[key] = value.double()
    return learner


def distances(got, exact, close):
    """(largest |param - exact|, share of elements beyond `close`) over the
    parameters (running statistics apart)."""
    names = dict(exact.network.named_parameters())
    worst, beyond, total = 0.0, 0, 0
    s_got = got.network.state_dict()
    for key, want in exact.network.state_dict().items():
        if key not in names:
            continue
        d = (s_got[key].detach().cpu().double() - want.detach().cpu().double()).abs()
        worst = max(worst, float(d.max()))
        beyond += int((d > close).sum())
        total += d.numel()
    return worst, beyond / total, total


def report(label, card, cpu, exact, close):
    rows = {}
    for name, learner in (("card", card), ("cpu", cpu)):
        worst, share, total = distances(learner, exact, close)
        rows[name] = {"max_from_f64": worst, "share_beyond": share}
    worst, share, total = distances(card, cpu, close)
    rows["card_vs_cpu"] = {"max": worst, "share_beyond": share}
    print(f"[{label}] {total} params; from the float64 step: card max {rows['card']['max_from_f64']:.4g}, "
          f"{100 * rows['card']['share_beyond']:.4f}% beyond {close}; CPU max "
          f"{rows['cpu']['max_from_f64']:.4g}, {100 * rows['cpu']['share_beyond']:.4f}% beyond; "
          f"card vs CPU max {worst:.4g}, {100 * share:.4f}% beyond", flush=True)
    return rows


def connect4_games():
    """Connect4 games of the shipped net on the card: a warm-up chunk and
    two timed ones at 256 lanes x 200 simulations (phase 4b's driver)."""
    from muzero_general_tpu_torch.checkpoint import load_checkpoint
    from muzero_general_tpu_torch.games import connect4
    from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    cfg = connect4.MuZeroConfig()
    cfg.parallel_games = 256
    net = MuZeroNetwork(cfg, seed=0)
    net.load_state_dict(params_from_jax(load_checkpoint(C4_CHECKPOINT)["weights"]))
    driver = SelfPlayDriver(connect4.make_env(), net, cfg, seed=0)
    games = []
    for _ in range(3):
        done, _ = driver.play(temperature=1.0)
        games += done
    return games


def connect4_case(batches):
    from muzero_general_tpu_torch.checkpoint import load_checkpoint, restore_learner
    from muzero_general_tpu_torch.games import connect4
    from muzero_general_tpu_torch.replay import ReplayBuffer
    from muzero_general_tpu_torch.trainer import Learner

    t0 = time.perf_counter()
    games = connect4_games()
    print(f"[connect4] {len(games)} games of self-play on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    checkpoint = load_checkpoint(C4_CHECKPOINT)
    out = {}
    for dtype, close in (("bfloat16", 1e-4), ("float32", 1e-5)):
        cfg = connect4.MuZeroConfig()
        cfg.compute_dtype = dtype
        buf = ReplayBuffer(cfg)
        for gh in games:
            buf.save_game(gh)
        for i in range(batches):
            buf.rng = np.random.default_rng(2 + i)
            _, batch = buf.get_batch()
            stacked = {k: v[None] for k, v in batch.items()}
            learners = []
            for dev in ("cuda", "cpu", "cpu"):
                learner = Learner(cfg, device=dev, seed=0)
                restore_learner(learner, checkpoint)
                learners.append(learner)
            to_float64(learners[2])
            t0 = time.perf_counter()
            for learner in learners:
                learner.train_steps(stacked)
            torch.cuda.synchronize()
            label = f"connect4 learner {dtype}, batch {i} (rng {2 + i})"
            out[f"{dtype}_{i}"] = report(label, *learners, close)
            print(f"[{label}] three steps in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def device_round_case():
    from muzero_general_tpu_torch.config import MuZeroConfig
    from muzero_general_tpu_torch.ops import device_replay as dr
    from muzero_general_tpu_torch.replay import GameHistory
    from muzero_general_tpu_torch.trainer import Learner

    cfg = MuZeroConfig()
    cfg.network, cfg.observation_shape, cfg.action_space = "resnet", (3, 3, 3), list(range(9))
    cfg.encoding_size, cfg.support_size = 4, 5
    cfg.num_unroll_steps, cfg.batch_size, cfg.optimizer = 3, 4, "SGD"
    cfg.blocks, cfg.channels = 1, 8
    cfg.reduced_channels_reward = cfg.reduced_channels_value = cfg.reduced_channels_policy = 2
    cfg.resnet_fc_reward_layers = cfg.resnet_fc_value_layers = [8]
    cfg.resnet_fc_policy_layers = [8]
    cfg.replay_buffer_size, cfg.max_moves, cfg.td_steps, cfg.PER = 6, 7, 3, True
    rng = np.random.default_rng(1)
    A = len(cfg.action_space)
    games = [GameHistory(
        observations=rng.normal(size=(n,) + tuple(cfg.observation_shape)).astype(np.float32),
        actions=np.concatenate([[0], rng.integers(0, A, n)]).astype(np.int32),
        rewards=np.concatenate([[0.0], rng.normal(size=n)]).astype(np.float32),
        to_play=(np.arange(n + 1) % 2).astype(np.int32),
        child_visits=rng.dirichlet(np.ones(A), n).astype(np.float32),
        root_values=rng.normal(size=n).astype(np.float32)) for n in (7, 3, 5, 6, 4, 7, 2)]
    rings = []
    for dev in ("cpu", "cuda"):
        ring = dr.init_replay(cfg.replay_buffer_size, cfg.max_moves, cfg.observation_shape, A,
                              dev)
        for chunk, valid in dr.pad_games_np(games, cfg.max_moves, cfg.observation_shape, A, 4):
            dr.save_games(ring, {k: torch.from_numpy(v).to(dev) for k, v in chunk.items()},
                          torch.from_numpy(valid).to(dev), td_steps=cfg.td_steps,
                          discount=cfg.discount, per_alpha=cfg.PER_alpha)
        rings.append(ring)
    cpu_ring, card_ring = rings
    gen = torch.Generator().manual_seed(2)
    B, U = cfg.batch_size, cfg.num_unroll_steps
    slots, pos, _, _ = dr.sample_indices(cpu_ring, gen, B)
    draws = {"slots": slots, "pos": pos, "fill_actions": torch.randint(0, A, (B, U + 1),
                                                                       generator=gen)}
    _, batch = dr.get_batch(cpu_ring, None, B, draws=draws, num_unroll_steps=U,
                            td_steps=cfg.td_steps, discount=cfg.discount, num_actions=A,
                            num_stacked=cfg.stacked_observations)
    cpu, card, exact = (Learner(cfg, device=dev, seed=0) for dev in ("cpu", "cuda", "cpu"))
    to_float64(exact)
    dr.make_device_train(cpu, cfg, 1)(cpu_ring, None, draws=[draws])
    dr.make_device_train(card, cfg, 1)(card_ring, None,
                                       draws=[{k: v.to("cuda") for k, v in draws.items()}])
    exact.train_step({k: v.numpy() for k, v in batch.items()})
    return {"resnet_device_round": report("device round, ResNet 1 x 8, SGD, one step", card, cpu,
                                          exact, 1e-5)}


def seeded_batch(cfg, seed):
    """A seeded random batch at the config's shapes (chip_smoke.py
    mesh_batch)."""
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


def seed0_unroll_case():
    from muzero_general_tpu_torch.games import connect4
    from muzero_general_tpu_torch.trainer import Learner

    def step(cfg, batch, exact=False):
        learner = Learner(cfg, device="cuda", seed=0)
        if exact:
            to_float64(learner)
        metrics, priorities = learner.train_step(batch)
        return float(metrics["total_loss"]), priorities.double().cpu().numpy(), learner

    def apart(cfg, batch, got, want):
        (loss, prio, learner), (want_loss, want_prio, exact) = got, want
        alpha = cfg.PER_alpha
        gap = float(np.abs(prio ** (1 / alpha) - want_prio ** (1 / alpha)).max())
        worst, share, _ = distances(learner, exact, 1e-5)
        return {"loss_rel": abs(loss - want_loss) / abs(want_loss), "gap": gap,
                "gap_bound": 1e-4 * max(float(np.abs(batch["target_value"]).max()), 1.0),
                "param_max": worst, "share_beyond": share}

    out = {}
    for unroll in (3, 5, 10, 20, 30, 42):
        cfg = connect4.MuZeroConfig()
        cfg.num_unroll_steps = unroll
        batch = seeded_batch(cfg, 17)
        f32, again, exact = step(cfg, batch), step(cfg, batch), step(cfg, batch, exact=True)
        out[f"unroll_{unroll}"] = row = {"f32_vs_f64": apart(cfg, batch, f32, exact),
                                         "f32_vs_f32": apart(cfg, batch, f32, again)}
        print(f"[connect4 seed 0, unroll {unroll}] " + "; ".join(
            f"{name}: loss {d['loss_rel']:.3g} relative, |value - target| within "
            f"{d['gap']:.3g} (LEARN_F32 bound {d['gap_bound']:.3g}), params max "
            f"{d['param_max']:.3g}, {100 * d['share_beyond']:.4f}% beyond 1e-5"
            for name, d in row.items()), flush=True)
    return {"connect4_seed0_unroll": out}


CASES = {"device_round": lambda args: device_round_case(),
         "connect4": lambda args: connect4_case(args.batches),
         "seed0_unroll": lambda args: seed0_unroll_case()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, default=3)
    parser.add_argument("--cases", default=",".join(CASES),
                        help="comma-separated, of " + ", ".join(CASES))
    args = parser.parse_args(argv)
    cases = args.cases.split(",")
    unknown = set(cases) - set(CASES)
    if unknown:
        parser.error(f"unknown cases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("float64_check: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    figures = {}
    for case in cases:
        figures.update(CASES[case](args))
    print(json.dumps({"card": smi, "figures": figures}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
