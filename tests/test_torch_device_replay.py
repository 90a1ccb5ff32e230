"""The port's device replay (muzero_general_tpu_torch/ops/device_replay.py)
and its engagement in the training loop, against the JAX package's.

Games are made from a seed with numpy; both rings are filled from the same
padded games. Then:
- save_games: ids, lengths, eviction, total_samples exactly; priorities
  within RING_PRIO_RTOL (|v - target| ** alpha, where the JAX ring sums
  the n-step target's rewards in XLA's order);
- assemble_batch on forced draws (JAX's own slots, positions and fill
  actions, drawn from its keys): actions, policies, rewards, observations
  and gradient scales exactly, value targets within TARGET_RTOL, IS weights
  within WEIGHT_RTOL; also against the port's host replay.make_target, as
  tests/test_device_replay.py holds JAX's;
- update_priorities and update_reanalysed_values with their stale guards,
  and pad_games_np, exactly;
- one make_device_train call on forced draws from the same ring and
  weights (the FC net and a small ResNet): losses, priorities, params and
  the Adam state within test_torch_trainer.py's tolerances;
- MuZero.train with device_replay against JAX's MuZero._train on scripted
  games (test_torch_muzero.py's stub drivers), JAX's draws of every device
  train round injected into the port: the branch taken at every step, the
  ring at every device round, the values reanalyse mirrors into it, and the
  step counts.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muzero_general_tpu.muzero as jax_muzero
from muzero_general_tpu.ops import device_replay as jax_dr
from muzero_general_tpu.replay import GameHistory as JaxGameHistory
from muzero_general_tpu.replay import ReplayBuffer as JaxReplayBuffer
from muzero_general_tpu.trainer import make_fused_train_steps
from muzero_general_tpu_torch import muzero as port_muzero
from muzero_general_tpu_torch.models import params_to_jax
from muzero_general_tpu_torch.ops import device_replay as dr
from muzero_general_tpu_torch.ops.stacking import stack_observations_np
from muzero_general_tpu_torch.replay import GameHistory, make_target
from test_torch_muzero import (  # noqa: F401 (one_torch_thread: a module fixture)
    CARTPOLE,
    StubDriver,
    _ratio,
    game_script,
    one_torch_thread,
)
from test_torch_trainer import (
    ADAM_PARAM_TOL,
    LOSS_ATOL,
    LOSS_RTOL,
    PRIO_ATOL,
    PRIO_RTOL,
    STATS_ATOL,
    STATS_RTOL,
    assert_trees_close,
    check_optimizer_state,
    setup,
)

# The n-step targets: float32 sums of up to td_steps discounted rewards, in
# another order than XLA's (observed <= 2 ulps).
TARGET_RTOL, TARGET_ATOL = 1e-6, 1e-6
# Initial priorities |v - target| ** PER_alpha of those targets (observed
# 8.5e-8 relative; a small |v - target| magnifies a target's ulp).
RING_PRIO_RTOL, RING_PRIO_ATOL = 1e-5, 1e-6
# IS weights 1 / (total * game_prob * pos_prob) over the batch's largest:
# the probabilities are sums of priorities in another order.
WEIGHT_RTOL = 1e-5


class Cfg:
    seed = 0
    PER = True
    PER_alpha = 0.7
    td_steps = 5
    discount = 0.95
    num_unroll_steps = 4
    batch_size = 6
    replay_buffer_size = 8
    action_space = list(range(3))
    stacked_observations = 1
    observation_shape = (2, 3, 3)
    max_moves = 9


def rand_game(rng, L, cfg):
    A = len(cfg.action_space)
    c, h, w = cfg.observation_shape
    return dict(
        observations=rng.normal(size=(L, c, h, w)).astype(np.float32),
        actions=np.concatenate([[0], rng.integers(0, A, L)]).astype(np.int32),
        rewards=np.concatenate([[0.0], rng.normal(size=L)]).astype(np.float32),
        to_play=rng.integers(0, 2, L + 1).astype(np.int32),
        child_visits=rng.dirichlet(np.ones(A), L).astype(np.float32),
        root_values=rng.normal(size=L).astype(np.float32),
    )


def pad(games, cfg, k_pad=None):
    """One chunk of pad_games_np: (numpy dict, valid)."""
    ghs = [GameHistory(**copy.deepcopy(g)) for g in games]
    chunks = dr.pad_games_np(ghs, cfg.max_moves, cfg.observation_shape,
                             len(cfg.action_space), k_pad or len(games))
    assert len(chunks) == 1
    return chunks[0]


def both_rings(cfg, loads, use_per=True):
    """JAX's ring and the port's after the same save_games calls; `loads`
    is a list of (games, valid) numpy chunks."""
    A = len(cfg.action_space)
    kw = dict(td_steps=cfg.td_steps, discount=cfg.discount, per_alpha=cfg.PER_alpha,
              use_per=use_per)
    jstate = jax_dr.init_replay(cfg.replay_buffer_size, cfg.max_moves, cfg.observation_shape, A)
    tstate = dr.init_replay(cfg.replay_buffer_size, cfg.max_moves, cfg.observation_shape, A,
                            "cpu")
    for chunk, valid in loads:
        jstate = jax_dr.save_games(jstate, {k: jnp.asarray(v.copy()) for k, v in chunk.items()},
                                   jnp.asarray(valid.copy()), **kw)
        out = dr.save_games(tstate, {k: torch.from_numpy(v.copy()) for k, v in chunk.items()},
                            torch.from_numpy(valid.copy()), **kw)
        assert out is tstate  # in place
    return jax.tree_util.tree_map(np.asarray, jstate), tstate


EXACT_FIELDS = ("observations", "actions", "rewards", "to_play", "child_visits", "game_len",
                "game_id", "num_played_games", "total_samples")


def assert_rings_equal(got, want, prio_rtol=RING_PRIO_RTOL, prio_atol=RING_PRIO_ATOL,
                       values_atol=0.0):
    for name in EXACT_FIELDS:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got.root_values.numpy(), np.asarray(want.root_values),
                               rtol=0, atol=values_atol, err_msg="root_values")
    for name in ("priorities", "game_priority"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=prio_rtol, atol=prio_atol, err_msg=name)


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_per", [True, False])
def test_save_games_matches_jax_with_eviction(use_per):
    """Ten games into a ring of 8 in three calls, padded lanes skipped (one
    game of length 0 among them): games 0 and 1 evicted."""
    cfg = Cfg()
    rng = np.random.default_rng(2)
    lens = [4, 5, 6, 7, 8, 9, 3, 2, 5, 6]
    games = [rand_game(rng, L, cfg) for L in lens]
    first, valid = pad(games[:5], cfg, k_pad=6)  # lane 5 padding
    second, valid2 = pad(games[5:8], cfg, k_pad=4)
    second["length"][3] = 0
    valid2[3] = True  # a valid lane holding no game: skipped too
    third = pad(games[8:], cfg)
    jstate, tstate = both_rings(cfg, [(first, valid), (second, valid2), third], use_per)
    assert_rings_equal(tstate, jstate)
    assert int(tstate.num_played_games) == 10
    assert tstate.game_id[:2].tolist() == [8, 9] and tstate.game_len[:2].tolist() == [5, 6]
    assert int(tstate.total_samples) == sum(lens[2:])


def test_pad_games_np_matches_jax():
    from muzero_general_tpu.replay import GameHistory as JaxGameHistory

    cfg = Cfg()
    rng = np.random.default_rng(8)
    games = [rand_game(rng, L, cfg) for L in (3, 9, 5)]
    games[1]["reanalysed_predicted_root_values"] = rng.normal(size=9).astype(np.float32)
    got = dr.pad_games_np([GameHistory(**copy.deepcopy(g)) for g in games], cfg.max_moves,
                          cfg.observation_shape, 3, 2)
    want = jax_dr.pad_games_np([JaxGameHistory(**copy.deepcopy(g)) for g in games],
                               cfg.max_moves, cfg.observation_shape, 3, 2)
    assert len(got) == len(want) == 2
    for (g, gv), (w, wv) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        assert g.keys() == w.keys()
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _ring_with(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    games = [rand_game(rng, L, cfg) for L in lens]
    jstate, tstate = both_rings(cfg, [pad(games, cfg)])
    return games, jstate, tstate


def jax_draws(jstate, key, cfg, B, use_per=True):
    """JAX get_batch's draws from `key` (JAX device_replay.py:320-332):
    slots and positions from sample_indices, the fill actions of
    assemble_batch's per-row keys."""
    ks, ka = jax.random.split(key)
    slots, pos, _, _ = jax_dr.sample_indices(jstate, ks, B, use_per=use_per)
    U1 = cfg.num_unroll_steps + 1
    A = len(cfg.action_space)
    fill = jax.vmap(lambda k: jax.random.randint(k, (U1,), 0, A))(jax.random.split(ka, B))
    return {"slots": np.asarray(slots), "pos": np.asarray(pos), "fill_actions": np.asarray(fill)}


def _torch_draws(draws):
    return {k: torch.from_numpy(v.copy()) for k, v in draws.items()}


@pytest.mark.parametrize("use_per", [True, False])
def test_get_batch_on_jax_draws_matches_jax(use_per):
    """The whole batch on JAX's own draws, and its parts against the
    port's host make_target and stacking."""
    cfg = Cfg()
    games, jstate, tstate = _ring_with(cfg, (7, 9, 4, 6), seed=1)
    B, U, A = 12, cfg.num_unroll_steps, 3
    key = jax.random.PRNGKey(3)
    kw = dict(num_unroll_steps=U, td_steps=cfg.td_steps, discount=cfg.discount,
              num_actions=A, num_stacked=cfg.stacked_observations, use_per=use_per)
    jib, jbatch = jax_dr.get_batch(jax.tree_util.tree_map(jnp.asarray, jstate), key, B, **kw)
    draws = jax_draws(jstate, key, cfg, B, use_per)
    tib, tbatch = dr.get_batch(tstate, None, B, draws=_torch_draws(draws), **kw)

    np.testing.assert_array_equal(tib.numpy(), np.asarray(jib))
    assert tib.dtype == torch.int32
    for name in ("action", "target_reward", "target_policy", "observation", "gradient_scale"):
        g, w = tbatch[name].numpy(), np.asarray(jbatch[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(tbatch["target_value"].numpy(), np.asarray(jbatch["target_value"]),
                               rtol=TARGET_RTOL, atol=TARGET_ATOL)
    np.testing.assert_allclose(tbatch["weight"].numpy(), np.asarray(jbatch["weight"]),
                               rtol=WEIGHT_RTOL)
    assert tbatch["weight"].max() == 1.0
    # Some rows reach past their game's end: random fill actions.
    lens = np.asarray(jstate.game_len)[draws["slots"]]
    assert (draws["pos"] + U > lens).any()

    # The host path on the same (game, position) pairs: make_target and
    # the stacking (tests/test_device_replay.py:113).
    nrng = np.random.default_rng(0)
    for i in range(B):
        gh = GameHistory(**copy.deepcopy(games[int(draws["slots"][i])]))
        p = int(draws["pos"][i])
        v, r, pol, a = make_target(gh, p, U, cfg.td_steps, cfg.discount, A, nrng)
        np.testing.assert_allclose(tbatch["target_value"][i].numpy(), v, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tbatch["target_reward"][i].numpy(), r, rtol=0, atol=0)
        np.testing.assert_allclose(tbatch["target_policy"][i].numpy(), pol, rtol=1e-7)
        det = p + np.arange(U + 1) <= len(gh)
        np.testing.assert_array_equal(tbatch["action"][i].numpy()[det], a[det])
        np.testing.assert_array_equal(
            tbatch["observation"][i].numpy(),
            stack_observations_np(gh.observations, gh.actions, p, cfg.stacked_observations, A))
        assert (tbatch["gradient_scale"][i] == min(U, len(gh) + 1 - p)).all()


def test_is_weights_follow_the_forced_probabilities():
    """assemble_batch's IS weights against JAX's on unequal forced
    probabilities; the largest is 1."""
    cfg = Cfg()
    _, jstate, tstate = _ring_with(cfg, (7, 9, 4), seed=6)
    rng = np.random.default_rng(6)
    B = 6
    slots = np.array([0, 0, 1, 2, 2, 1], np.int32)
    pos = np.array([0, 6, 8, 0, 3, 2], np.int32)
    gprob = rng.uniform(0.05, 0.6, B).astype(np.float32)
    pprob = rng.uniform(0.05, 0.5, B).astype(np.float32)
    kw = dict(num_unroll_steps=cfg.num_unroll_steps, td_steps=cfg.td_steps,
              discount=cfg.discount, num_actions=3, num_stacked=1, use_per=True)
    _, jbatch = jax_dr.assemble_batch(jax.tree_util.tree_map(jnp.asarray, jstate),
                                      jax.random.PRNGKey(0), jnp.asarray(slots), jnp.asarray(pos),
                                      jnp.asarray(gprob), jnp.asarray(pprob), **kw)
    _, tbatch = dr.assemble_batch(tstate, torch.Generator().manual_seed(0),
                                  torch.from_numpy(slots), torch.from_numpy(pos),
                                  torch.from_numpy(gprob), torch.from_numpy(pprob), **kw)
    want = 1.0 / (int(jstate.total_samples) * gprob.astype(np.float64) * pprob)
    np.testing.assert_allclose(tbatch["weight"].numpy(), want / want.max(), rtol=WEIGHT_RTOL)
    np.testing.assert_allclose(tbatch["weight"].numpy(), np.asarray(jbatch["weight"]),
                               rtol=WEIGHT_RTOL)
    assert float(tbatch["weight"].max()) == 1.0 and len(set(tbatch["weight"].tolist())) == B


def test_update_priorities_stale_guard_and_clip_match_jax():
    """A write clipped at the game's length, a fresh write, a stale id that
    must be ignored (aimed at the fresh row's cells), and a second write to
    cells the first wrote (the later row wins)."""
    cfg = Cfg()
    _, jstate, tstate = _ring_with(cfg, (6, 9), seed=3)
    U1 = cfg.num_unroll_steps + 1
    new_pr = np.stack([np.full(U1, 7.0), np.full(U1, 5.0), np.full(U1, 3.0),
                       np.arange(U1) + 10.0]).astype(np.float32)
    index_batch = np.array([[0, 4, 0], [1, 0, 1], [99, 0, 1], [0, 2, 0]], np.int32)
    want = jax_dr.update_priorities(jax.tree_util.tree_map(jnp.asarray, jstate),
                                    jnp.asarray(new_pr[:3]), jnp.asarray(index_batch[:3]))
    got = dr.update_priorities(copy.deepcopy(tstate), torch.from_numpy(new_pr[:3]),
                               torch.from_numpy(index_batch[:3]))
    for name in ("priorities", "game_priority"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=RING_PRIO_RTOL, atol=RING_PRIO_ATOL, err_msg=name)
    row0, row1 = got.priorities[0].numpy(), got.priorities[1].numpy()
    np.testing.assert_array_equal(row0[4:6], 7.0)
    np.testing.assert_array_equal(row0[6:], 0.0)  # beyond the game's length
    np.testing.assert_array_equal(row1[:U1], 5.0)  # the stale row wrote nothing
    np.testing.assert_array_equal(row1[U1:], tstate.priorities[1].numpy()[U1:])
    # Repeated cells: rows 0 and 3 both aim at game 0's positions 4 and 5;
    # the later row's values land.
    got = dr.update_priorities(copy.deepcopy(tstate), torch.from_numpy(new_pr),
                               torch.from_numpy(index_batch))
    np.testing.assert_array_equal(got.priorities[0].numpy()[2:6], [10.0, 11.0, 12.0, 13.0])
    assert float(got.game_priority[0]) == 13.0


def test_reanalysed_values_guard_matches_jax():
    cfg = Cfg()
    _, jstate, tstate = _ring_with(cfg, (5, 5), seed=5)
    fresh = np.arange(cfg.max_moves, dtype=np.float32)
    jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
    for slot, gid in ((1, 1), (0, 42)):  # fresh, then stale
        want = jax_dr.update_reanalysed_values(jstate, slot, gid, jnp.asarray(fresh))
        got = dr.update_reanalysed_values(copy.deepcopy(tstate), slot, gid,
                                          torch.from_numpy(fresh))
        np.testing.assert_array_equal(got.root_values.numpy(), np.asarray(want.root_values))
    np.testing.assert_array_equal(got.root_values[0].numpy(), tstate.root_values[0].numpy())


def test_sampling_respects_per_and_liveness():
    """The port's own draw at a fixed seed: a dominant game is drawn almost
    always, empty slots never, positions inside their game, and positions
    follow their priorities."""
    cfg = Cfg()
    _, _, state = _ring_with(cfg, (6, 6, 6), seed=4)
    state.game_priority.copy_(torch.tensor([0.01, 100.0, 0.01] + [0.0] * 5))
    state.priorities[1].zero_()
    state.priorities[1, 2] = 1.0  # game 1: only position 2 has priority
    gen = torch.Generator().manual_seed(0)
    slots, pos, gprob, pprob = dr.sample_indices(state, gen, 512)
    slots, pos = slots.numpy(), pos.numpy()
    assert (slots == 1).mean() > 0.95 and set(np.unique(slots)) <= {0, 1, 2}
    assert (pos < 6).all() and (pos[slots == 1] == 2).all()
    np.testing.assert_allclose(gprob.numpy()[slots == 1], 100.0 / 100.02, rtol=1e-6)
    np.testing.assert_allclose(pprob.numpy()[slots == 1], 1.0)
    # Uniform: every live game, never an empty slot.
    slots_u, _, gprob_u, _ = dr.sample_indices(state, gen, 512, use_per=False)
    assert set(np.unique(slots_u.numpy())) == {0, 1, 2}
    np.testing.assert_allclose(gprob_u.numpy(), 1 / 3, rtol=1e-6)


# ---------------------------------------------------------------------------
# The fused device train round
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("network", ["fullyconnected", "resnet"])
def test_device_train_round_matches_jax(network):
    """make_device_train at M = 4 from one ring and one set of weights, the
    port on JAX's draws of each of the four batches (taken from the same
    ring state, as JAX takes them): the last step's losses, the ring's
    priorities after the four write-backs, the params, batch statistics
    and Adam state."""
    M = 4
    jcfg, runner, state, learner = setup(network, PER=True, replay_buffer_size=6, max_moves=7,
                                         td_steps=3)
    cfg = learner.config
    rng = np.random.default_rng(9)
    games = [rand_game(rng, L, cfg) for L in (7, 3, 5, 6, 4)]
    if len(cfg.players) == 1:
        for g in games:
            g["to_play"][:] = 0
    jdev, tdev = both_rings(cfg, [pad(games, cfg)])
    key = jax.random.PRNGKey(11)
    draws = [jax_draws(jdev, k, cfg, cfg.batch_size) for k in jax.random.split(key, M)]

    fn = jax_dr.make_device_train(runner, jcfg, make_fused_train_steps(runner, jcfg, jit=False),
                                  M)
    jdev2, jstate, jm = fn(jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jdev),
                           state, key)
    jdev2 = jax.tree_util.tree_map(np.asarray, jdev2)
    tm = dr.make_device_train(learner, cfg, M)(tdev, None,
                                              draws=[_torch_draws(d) for d in draws])

    for name in ("total_loss", "value_loss", "reward_loss", "policy_loss", "lr"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=name)
    assert_rings_equal(tdev, jdev2, prio_rtol=PRIO_RTOL, prio_atol=PRIO_ATOL)
    written = np.asarray(jdev2.priorities) != np.asarray(jdev.priorities)
    assert written.sum() >= cfg.batch_size  # the write-backs landed
    got = params_to_jax(learner.network)
    assert_trees_close(got["params"], jstate.params, ADAM_PARAM_TOL * cfg.lr_init * M,
                       what="params")
    assert_trees_close(got["batch_stats"], jstate.batch_stats, STATS_ATOL, STATS_RTOL,
                       what="batch_stats")
    assert learner.training_step == int(jstate.step) == M
    check_optimizer_state(jstate, learner)


# ---------------------------------------------------------------------------
# The training loop with device replay
# ---------------------------------------------------------------------------

# The loop case: cartpole at test_torch_muzero.py's small widths, device
# replay at M = 4, PER, a rising ratio (device rounds and single host steps).
LOOP = dict(CARTPOLE, device_replay=True, fused_train_steps=4, PER=True, ratio=_ratio,
            training_steps=28)
# Reanalysed values mirrored into the ring: the same games through weights
# that agree within test_torch_muzero.py's loop tolerances; the params'
# drift over the loop reaches the decoded values (observed 1.6e-4 at 0.45
# after 20 steps).
MIRROR_ATOL = 5e-4
# The ring's priorities in the loop, compared as |value - target| =
# priority ** (1 / PER_alpha) (the square root's slope near 0 would magnify
# any difference, as chip_smoke compares the learner's): after a dozen steps
# the params' drift reaches the decoded values (observed 1.46e-4 on one
# position, every other within 1e-4 relative).
LOOP_GAP_ATOL = 5e-4


def _ring_np(state):
    return type(state)(*(np.array(x) for x in state))


def test_train_loop_with_device_replay_matches_jax(tmp_path, monkeypatch):
    """JAX's MuZero._train and the port's MuZero.train on the same scripted
    games (stub drivers), device replay engaged on both: every train call's
    branch (a device round of M steps or a single host step) in order; at
    every device round the port trains on JAX's draws of that round (taken
    from JAX's ring), and afterwards the two rings agree (the games, ids,
    lengths and counters exactly, the root values with reanalyse's mirrored
    values within MIRROR_ATOL, the priorities within LOOP_GAP_ATOL);
    the values the sweeps mirror agree game for game; the step counts
    match."""
    jmz = jax_muzero.MuZero("cartpole", dict(LOOP, results_path=str(tmp_path / "jax")))
    weights = copy.deepcopy(jmz.checkpoint["weights"])
    script = game_script(jmz.config, seed=7)
    kinds = {"jax": [], "port": []}
    rings = {"jax": [], "port": []}
    mirrored = {"jax": [], "port": []}
    jax_round_draws = []

    # ---- JAX: count the branches, record each round's draws and ring ------
    def counting(factory, kind):
        def make(*args, **kwargs):
            fn = factory(*args, **kwargs)
            if kwargs.get("jit", True) is False:  # the device round's inner steps
                return fn

            def call(*a):
                kinds["jax"].append(kind)
                return fn(*a)

            return call

        return make

    make_round = jax_dr.make_device_train

    def jax_device_train(runner, cfg, fused_raw, M):
        fn = make_round(runner, cfg, fused_raw, M)

        def call(dev, state, rng):
            kinds["jax"].append("device")
            dev_np = jax.tree_util.tree_map(np.asarray, dev)
            jax_round_draws.append([jax_draws(dev_np, k, cfg, cfg.batch_size)
                                    for k in jax.random.split(rng, M)])
            out = fn(dev, state, rng)
            rings["jax"].append(jax.tree_util.tree_map(np.array, out[0]))
            return out

        return call

    def recording_sweep(cls, side):
        sweep = cls._reanalyse_sweep

        def wrapped(self, *args, on_update=None, **kwargs):
            assert on_update is not None  # device replay: the mirror is on

            def record(gid, values):
                mirrored[side].append((gid, np.array(values)))
                on_update(gid, values)

            return sweep(self, *args, on_update=record, **kwargs)

        return wrapped

    get_batch = JaxReplayBuffer.get_batch
    monkeypatch.setattr(JaxReplayBuffer, "get_batch",
                        lambda self, use_native=True: get_batch(self, use_native=False))
    monkeypatch.setattr(jax_muzero, "make_train_step",
                        counting(jax_muzero.make_train_step, "single"))
    monkeypatch.setattr(jax_muzero, "make_fused_train_steps",
                        counting(jax_muzero.make_fused_train_steps, "fused"))
    monkeypatch.setattr(jax_dr, "make_device_train", jax_device_train)
    monkeypatch.setattr(jax_muzero.MuZero, "_reanalyse_sweep",
                        recording_sweep(jax_muzero.MuZero, "jax"))
    jmz._make_driver = lambda runner, **kw: StubDriver(script, JaxGameHistory, None,
                                                       kw.get("greedy_lanes", 0))
    jck = jmz.train()
    monkeypatch.undo()

    # ---- the port on JAX's draws --------------------------------------------
    from muzero_general_tpu_torch.trainer import Learner

    train_step = Learner.train_step
    monkeypatch.setattr(Learner, "train_step",
                        lambda self, batch: (kinds["port"].append("single"),
                                             train_step(self, batch))[1])
    monkeypatch.setattr(Learner, "train_steps", lambda self, batches: pytest.fail(
        "the host's fused path ran where device replay engages"))
    port_make_round = dr.make_device_train
    pending = list(jax_round_draws)

    def port_device_train(learner, cfg, M):
        fn = port_make_round(learner, cfg, M)

        def call(dev, generator, draws=None):
            kinds["port"].append("device")
            metrics = fn(dev, generator, draws=[_torch_draws(d) for d in pending.pop(0)])
            rings["port"].append(_ring_np(dev))
            return metrics

        return call

    monkeypatch.setattr(dr, "make_device_train", port_device_train)
    monkeypatch.setattr(port_muzero.MuZero, "_reanalyse_sweep",
                        recording_sweep(port_muzero.MuZero, "port"))
    tmz = port_muzero.MuZero("cartpole", dict(LOOP, results_path=str(tmp_path / "port")),
                             device="cpu")
    tmz.checkpoint["weights"] = copy.deepcopy(weights)
    tmz._make_driver = lambda network, **kw: StubDriver(script, GameHistory, network,
                                                        kw.get("greedy_lanes", 0))
    tck = tmz.train()
    monkeypatch.undo()

    assert tmz.device_ring is not None
    assert jck["training_step"] == tck["training_step"] == LOOP["training_steps"]
    assert kinds["port"] == kinds["jax"]
    assert {"device", "single"} <= set(kinds["port"])
    assert not pending and len(rings["port"]) == len(rings["jax"]) >= 3
    alpha = tmz.config.PER_alpha
    for got, want in zip(rings["port"], rings["jax"]):
        got = type(got)(*(torch.from_numpy(x) for x in got))
        assert_rings_equal(got, want, prio_rtol=np.inf, values_atol=MIRROR_ATOL)
        for name in ("priorities", "game_priority"):
            np.testing.assert_allclose(getattr(got, name).numpy() ** (1 / alpha),
                                       getattr(want, name) ** (1 / alpha), rtol=0,
                                       atol=LOOP_GAP_ATOL, err_msg=name)
    assert len(mirrored["port"]) == len(mirrored["jax"]) > 0
    for (gid, got), (jgid, want) in zip(mirrored["port"], mirrored["jax"]):
        assert gid == jgid
        np.testing.assert_allclose(got, want, rtol=0, atol=MIRROR_ATOL)
    # The mirrored values reached the ring: the last sweep's games hold them.
    last = _ring_np(tmz.device_ring.state)
    G = LOOP.get("replay_buffer_size", tmz.config.replay_buffer_size)
    for gid, values in mirrored["port"][-3:]:
        slot = gid % G
        if last.game_id[slot] == gid:
            np.testing.assert_array_equal(last.root_values[slot][:len(values)], values)
    for key in ("num_played_games", "num_played_steps", "num_reanalysed_games"):
        assert tck[key] == jck[key], key
    assert int(last.num_played_games) == tck["num_played_games"]
