"""The port's Gumbel search (muzero_general_tpu_torch/ops/gumbel.py) and its
engagement in self-play and evaluation, against the JAX package's.

Both sides get the same inputs, made from a seed with numpy, and the same
Gumbel draw: the JAX search's own, jax.random.gumbel(fold_in(key, 0),
(B, A)) (JAX ops/gumbel.py:306), injected into the port. Networks:
- tests/test_gumbel.py's deterministic model, tabulated over its 97 hidden
  states from JAX's own evaluation, so both sides see bit-identical logits;
- a cartpole FC net and a small tictactoe ResNet, the JAX variables carried
  into the port with params_from_jax.
Visit counts, tree shape, depths, `action` and `greedy_action` must then be
exact. Values agree to tolerances: the support decode rounds differently in
the two frameworks (~3e-5 relative, tests/test_torch_mcts.py), so root values
within ROOT_ATOL + ROOT_RTOL relative (observed 2.4e-5 relative at 4.4),
and the improved policy within POLICY_ATOL: its logits carry (c_visit +
max N) x q_hat, 50-70 x q_hat's rounding (up to ~1e-5), and a softmax
entry moves by at most p (1 - p) <= 1/4 of its logit's difference
(observed 5.2e-5). The real nets' logits differ in float32 ulps on top.

The self-play driver is held move for move against JAX's on simple_grid (FC)
and tictactoe (ResNet), whose resets draw nothing, with the JAX driver's
per-move Gumbel draws injected; evaluation games against JAX's
play_against_opponent on tictactoe.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.ops import gumbel as jax_gumbel
from muzero_general_tpu_torch.ops import gumbel as gumbel_ops
from test_torch_muzero import one_torch_thread  # noqa: F401 (a module fixture)

SUPPORT = 5
NBINS = 2 * SUPPORT + 1
TABLE = 97
ROOT_ATOL, ROOT_RTOL = 1e-4, 5e-5
POLICY_ATOL = 2e-4
# The real nets: the min-max normalization divides by the spread of a
# node's q values, small for random weights, which magnifies the decode's
# rounding in q_hat (observed 5.4e-4 in the ResNet's improved policy, a
# 7.7e-3 logit difference on a 0.07 entry).
NET_POLICY_ATOL = 2e-3
# The drivers' policy targets: the JAX driver's chunk is jitted, and XLA's
# fusions round the tictactoe ResNet's values apart from its eager ops too;
# through the magnification above an entry moves by up to ~1% of itself
# (observed 8.5e-3 relative on a 0.36 entry, with every action equal).
DRIVER_POLICY_RTOL = 2e-2


# ---------------------------------------------------------------------------
# The halving schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", range(17))
def test_schedules_equal_jax(m):
    for n in range(1, 65):
        assert (gumbel_ops.sequence_of_considered_visits(m, n)
                == jax_gumbel.sequence_of_considered_visits(m, n)), (m, n)
    for n in (1, 7, 16, 50, 64):
        got = gumbel_ops.table_of_considered_visits(m, n)
        want = jax_gumbel.table_of_considered_visits(m, n)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The search against JAX's
# ---------------------------------------------------------------------------


def _det_tables(A):
    """tests/test_gumbel.py's deterministic model, evaluated by JAX over its
    97 hidden states: (value, reward, policy) logits [97, ...]."""
    from test_gumbel import _det_logits

    h = jnp.arange(TABLE, dtype=jnp.float32)
    return tuple(np.asarray(_det_logits(h, size, salt))
                 for size, salt in ((NBINS, 1.3), (NBINS, 0.4), (A, 2.7)))


def jax_det_model(tables, A):
    tv, tr, tp = (jnp.asarray(t) for t in tables)

    def initial_fn(obs):
        ids = obs.astype(jnp.int32)
        return tv[ids], jnp.zeros((obs.shape[0], NBINS)), tp[ids], obs.astype(jnp.float32)

    def recurrent_fn(hidden, action):
        h2 = (hidden * A + action + 1) % 97.0
        ids = h2.astype(jnp.int32)
        return tv[ids], tr[ids], tp[ids], h2

    return initial_fn, recurrent_fn


def torch_det_model(tables, A):
    tv, tr, tp = (torch.from_numpy(t.copy()) for t in tables)

    def initial_fn(obs):
        ids = obs.long()
        return tv[ids], torch.zeros((obs.shape[0], NBINS)), tp[ids], obs.float()

    def recurrent_fn(hidden, action):
        h2 = (hidden * A + action + 1) % 97.0
        ids = h2.long()
        return tv[ids], tr[ids], tp[ids], h2

    return initial_fn, recurrent_fn


def _specs(sims, m, num_players, support=SUPPORT, discount=None):
    common = dict(num_simulations=sims, num_players=num_players,
                  discount=(0.97 if num_players == 1 else 1.0) if discount is None else discount,
                  support_size=support, max_depth=sims, max_considered_actions=m)
    return jax_gumbel.GumbelSpec(**common), gumbel_ops.GumbelSpec(**common)


def _legal(B, A, kind, rng):
    if kind == "all":
        return np.ones((B, A), bool)
    if kind == "single":
        legal = np.zeros((B, A), bool)
        legal[np.arange(B), rng.integers(0, A, B)] = True
        return legal
    legal = rng.random((B, A)) < 0.6
    legal[np.arange(B), rng.integers(0, A, B)] = True
    return legal


def run_both(jax_fns, torch_fns, obs, legal, to_play, jspec, tspec, add_gumbel=True, seed=0):
    """JAX's run_gumbel_mcts, then the port's with JAX's Gumbel draw."""
    B, A = legal.shape
    key = jax.random.PRNGKey(seed)
    want = jax_gumbel.run_gumbel_mcts(
        *jax_fns, jnp.asarray(obs), jnp.asarray(legal), jnp.asarray(to_play), key, jspec,
        add_gumbel=add_gumbel)
    draw = np.asarray(jax.random.gumbel(jax.random.fold_in(key, 0), (B, A)))
    got = gumbel_ops.run_gumbel_mcts(
        *torch_fns, torch.from_numpy(np.array(obs)), torch.from_numpy(legal),
        torch.from_numpy(to_play), None, tspec, add_gumbel=add_gumbel,
        gumbel=torch.from_numpy(draw.copy()))
    return got, want


def assert_same_search(got, want, root_atol=ROOT_ATOL, policy_atol=POLICY_ATOL):
    for name in ("root_visit_counts", "max_tree_depth", "action", "greedy_action"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("children_index", "children_visit", "root_visit"):
        np.testing.assert_array_equal(getattr(got.tree, name).numpy(),
                                      np.asarray(getattr(want.tree, name)), err_msg=name)
    for name in ("root_value", "root_predicted_value"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=ROOT_RTOL, atol=root_atol, err_msg=name)
    np.testing.assert_allclose(got.improved_policy.numpy(), np.asarray(want.improved_policy),
                               rtol=0, atol=policy_atol)


# name: (B, A, sims, m, num_players, legal, add_gumbel)
DET_CASES = {
    "one_player": (8, 5, 12, 4, 1, "all", True),
    "two_players": (8, 5, 12, 4, 2, "all", True),
    "random_legal_one_player": (8, 5, 12, 4, 1, "random", True),
    "random_legal_two_players": (8, 5, 12, 4, 2, "random", True),
    "single_legal_action": (8, 5, 12, 4, 1, "single", True),
    "no_gumbel": (8, 5, 12, 4, 1, "random", False),
    "m_above_A": (8, 5, 12, 16, 2, "random", True),
    "n_below_m": (8, 5, 4, 16, 1, "all", True),
}


@pytest.mark.parametrize("case", list(DET_CASES))
def test_search_matches_jax_on_the_deterministic_model(case):
    B, A, sims, m, players, kind, add_gumbel = DET_CASES[case]
    rng = np.random.default_rng(sorted(DET_CASES).index(case))
    tables = _det_tables(A)
    obs = rng.integers(0, TABLE, B).astype(np.float32)
    legal = _legal(B, A, kind, rng)
    to_play = rng.integers(0, players, B).astype(np.int32)
    jspec, tspec = _specs(sims, m, players)
    got, want = run_both(jax_det_model(tables, A), torch_det_model(tables, A), obs, legal,
                         to_play, jspec, tspec, add_gumbel=add_gumbel, seed=B + A + sims)
    assert_same_search(got, want)
    visits = got.root_visit_counts.numpy()
    assert (visits.sum(-1) == sims).all() and (visits[~legal] == 0).all()
    if kind == "single":
        np.testing.assert_array_equal(got.action.numpy(), legal.argmax(-1))
    if sims >= 12:
        assert int(got.max_tree_depth.max()) >= 3


@functools.lru_cache(maxsize=None)
def _cached_pair(game, overrides):
    """(JAX config, runner, variables), (port config, network): one seed's
    JAX weights in both (made once per session: flax's eager init of the
    ResNet takes seconds). Callers copy the configs they change."""
    from muzero_general_tpu.config import load_game_module as jax_game
    from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
    from muzero_general_tpu_torch.config import load_game_module
    from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax

    jcfg, cfg = jax_game(game).MuZeroConfig(), load_game_module(game).MuZeroConfig()
    for key, value in overrides:
        setattr(jcfg, key, value)
        setattr(cfg, key, value)
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.array, runner.init(jax.random.PRNGKey(5)))
    network = MuZeroNetwork(cfg, device="cpu").eval()
    network.load_state_dict(params_from_jax(variables))
    return (jcfg, runner, variables), (cfg, network)


def _net_pair(game, **overrides):
    (jcfg, runner, variables), (cfg, network) = _cached_pair(
        game, tuple(sorted(overrides.items())))
    return (copy.copy(jcfg), runner, variables), (copy.copy(cfg), network)


SMALL_RESNET = dict(blocks=1, channels=4, reduced_channels_reward=2, reduced_channels_value=2,
                    reduced_channels_policy=2)
# name: (game, overrides, B, sims, m)
NET_CASES = {
    "cartpole_fc": ("cartpole", {}, 8, 16, 16),
    "tictactoe_resnet": ("tictactoe", SMALL_RESNET, 8, 16, 4),
}


@pytest.mark.parametrize("case", list(NET_CASES))
def test_search_matches_jax_on_a_real_net(case):
    game, overrides, B, sims, m = NET_CASES[case]
    (jcfg, runner, variables), (cfg, network) = _net_pair(game, **overrides)
    rng = np.random.default_rng(11)
    A = len(cfg.action_space)
    obs = rng.normal(size=(B,) + tuple(cfg.observation_shape)).astype(np.float32)
    legal = _legal(B, A, "random", rng)
    to_play = rng.integers(0, len(cfg.players), B).astype(np.int32)
    jspec, tspec = _specs(sims, m, len(cfg.players), support=cfg.support_size,
                          discount=cfg.discount)
    assert tspec == gumbel_ops.GumbelSpec.from_config(
        type("Cfg", (), dict(vars(cfg), num_simulations=sims,
                             gumbel_max_considered_actions=m))())
    jax_fns = (lambda o: runner.initial_inference(variables, o),
               lambda h, a: runner.recurrent_inference(variables, h, a))
    with torch.no_grad():
        got, want = run_both(jax_fns, (network.initial_inference, network.recurrent_inference),
                             obs, legal, to_play, jspec, tspec, seed=3)
    assert_same_search(got, want, policy_atol=NET_POLICY_ATOL)
    assert int(got.max_tree_depth.max()) >= 2


# ---------------------------------------------------------------------------
# The self-play driver against JAX's, move for move
# ---------------------------------------------------------------------------

# name: (game, overrides, G, K, sims, m, temperature_threshold)
DRIVER_CASES = {
    "simple_grid": ("simple_grid", {}, 6, 10, 8, 2, None),
    "simple_grid_threshold_2": ("simple_grid", {}, 6, 10, 8, 2, 2),
    "tictactoe": ("tictactoe", SMALL_RESNET, 6, 9, 12, 4, None),
    "tictactoe_threshold_2": ("tictactoe", SMALL_RESNET, 6, 9, 12, 4, 2),
}


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_driver_matches_jax_driver_move_for_move(case, monkeypatch):
    """Both drivers from the same weights and start states (tictactoe's
    lanes from mid-game boards the JAX side sets), the JAX driver's Gumbel
    draw of every move handed to the port: lanes 0 and 1 greedy
    (temperature 0), the others at 1. The games reset to a fixed start, so
    the whole chunk compares: actions, done flags, rewards, players,
    observations and depths exactly, the improved policy targets within
    DRIVER_POLICY_RTOL, root values within ROOT_ATOL + ROOT_RTOL."""
    from muzero_general_tpu.config import load_game_module as jax_game
    from muzero_general_tpu.selfplay import SelfPlayDriver as JaxDriver
    from muzero_general_tpu_torch.config import load_game_module
    from muzero_general_tpu_torch.selfplay import SelfPlayDriver

    game, overrides, G, K, sims, m, threshold = DRIVER_CASES[case]
    (jcfg, runner, variables), (cfg, network) = _net_pair(game, **overrides)
    for c in (jcfg, cfg):
        c.use_gumbel_mcts, c.num_simulations = True, sims
        c.gumbel_max_considered_actions, c.temperature_threshold = m, threshold
        c.parallel_games, c.selfplay_chunk_moves = G, K
    jd = JaxDriver(jax_game(game).make_env(), runner, jcfg, seed=0)
    assert jd.use_gumbel and not jd.use_fused
    jd._rng, k = jax.random.split(jd._rng)
    carry = jd._init_carry(jax.random.split(k, 1))
    start = None
    if game == "tictactoe":
        # Lanes 2-5 start from boards two and three plies in.
        boards = np.zeros((G, 3, 3), np.int8)
        for g, cells in zip(range(2, G), ([0, 4], [8, 1], [2, 6, 4], [3, 5, 7])):
            for i, cell in enumerate(cells):
                boards[g].flat[cell] = 1 if i % 2 == 0 else -1
        start = torch.from_numpy(boards)
        state = jax.vmap(jd.env.reset)(jax.random.split(k, G))
        player = np.where((boards != 0).sum((1, 2)) % 2 == 0, 1, -1).astype(np.int8)
        state = state._replace(board=jnp.asarray(boards, state.board.dtype),
                               player=jnp.asarray(player, state.player.dtype))
        obs0 = jax.vmap(jd.env.observation)(state)
        carry = carry._replace(env_state=state, obs_hist=carry.obs_hist.at[:, 0].set(obs0))
    temps = np.ones((G,), np.float32)
    temps[:2] = 0.0
    _, want = jd._get_play_chunk(K, True)(variables, carry, temps)
    want = jax.tree_util.tree_map(np.asarray, want)
    # The JAX driver's draws: each move splits the carried key into (rng,
    # k_mcts, k_sel, k_step, k_reset), and run_gumbel_mcts draws from
    # fold_in(k_mcts, 0) (JAX selfplay.py:174-190, ops/gumbel.py:306).
    draws, rng = [], carry.rng[0]
    A = len(cfg.action_space)
    for _ in range(K):
        rng, k_mcts, _, _, _ = jax.random.split(rng, 5)
        draws.append(torch.from_numpy(np.array(
            jax.random.gumbel(jax.random.fold_in(k_mcts, 0), (G, A)))))
    monkeypatch.setattr(gumbel_ops, "sample_gumbel", lambda *a, **k: draws.pop(0))

    driver = SelfPlayDriver(load_game_module(game).make_env(device="cpu"), network, cfg,
                            seed=0, device="cpu")
    assert driver.search_route == "staged" and driver.use_gumbel
    driver.reset(start=start)
    got = driver.play_chunk(torch.from_numpy(temps), K, add_noise=True)
    got = type(got)(*(f.numpy() for f in got))
    assert not draws  # one injected draw a move

    for name in ("action", "done", "reward", "to_play", "to_play_next", "observation",
                 "max_tree_depth"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    np.testing.assert_allclose(got.child_visits, want.child_visits, rtol=DRIVER_POLICY_RTOL,
                               atol=1e-7)
    for name in ("root_value", "pred_value"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=ROOT_RTOL,
                                   atol=ROOT_ATOL, err_msg=name)
    assert want.done.any()


# ---------------------------------------------------------------------------
# Evaluation games against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opponent,muzero_player", [("random", 0), ("random", 1), ("self", 0)])
def test_opponent_game_matches_jax(opponent, muzero_player):
    """evaluate.play_against_opponent under use_gumbel_mcts: the greedy
    Gumbel search (no draw) at B = 1 on both sides, the random opponent
    from np.random.default_rng(seed) on both. MuZero plays greedy_action:
    the games agree move for move, child visits exactly, root values
    within ROOT_ATOL + ROOT_RTOL."""
    from muzero_general_tpu import evaluate as jax_evaluate
    from muzero_general_tpu.config import load_game_module as jax_game
    from muzero_general_tpu_torch import evaluate
    from muzero_general_tpu_torch.config import load_game_module

    (jcfg, runner, variables), (cfg, network) = _net_pair("tictactoe", **SMALL_RESNET)
    for c in (jcfg, cfg):
        c.use_gumbel_mcts, c.num_simulations, c.gumbel_max_considered_actions = True, 12, 4
    want = jax_evaluate.play_against_opponent(
        jax_game("tictactoe").make_env(), runner, jcfg, variables, opponent, muzero_player,
        seed=4)
    got = evaluate.play_against_opponent(load_game_module("tictactoe").make_env(device="cpu"),
                                         network, cfg, opponent, muzero_player, seed=4)
    assert len(got) >= 5
    for field in ("actions", "rewards", "to_play", "child_visits"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    np.testing.assert_allclose(got.observations, want.observations, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.root_values, want.root_values, rtol=ROOT_RTOL,
                               atol=ROOT_ATOL)
    searched = got.child_visits.sum(-1) > 0
    assert searched.any() and (searched.all() if opponent == "self" else not searched.all())
