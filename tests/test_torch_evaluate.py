"""The port's evaluation (muzero_general_tpu_torch/evaluate.py, MuZero.test,
two_player_reward_split) and its envs' human-facing helpers against the JAX
package's.

Both sides play from the same weights with the B = 1 search's ties broken
at the first index (as test_torch_mcts.py sets them) and no root noise
(root_exploration_fraction 0, so the noise draw cannot matter): against the
random opponent, whose draws come from np.random.default_rng(seed) on both
sides, and against itself from a carried cartpole start state (JAX's own
draw, handed to the port). Actions, rewards, to_play and child visits must
then be exact and root values agree within 5e-5 (the search tests'
tolerance: float32 h^-1 quantizes leaf values).
"""

import builtins

import jax
import numpy as np
import pytest
import torch

from muzero_general_tpu import MuZero as JaxMuZero
from muzero_general_tpu import evaluate as jax_evaluate
from muzero_general_tpu.config import load_game_module as jax_game
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.muzero import two_player_reward_split as jax_split
from muzero_general_tpu.replay import GameHistory as JaxGameHistory
from muzero_general_tpu_torch import MuZero, evaluate
from muzero_general_tpu_torch.config import load_game_module
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from muzero_general_tpu_torch.muzero import two_player_reward_split
from muzero_general_tpu_torch.replay import GameHistory
from test_torch_muzero import (  # noqa: F401 (one_torch_thread: a module fixture)
    TICTACTOE,
    deterministic_specs,
    one_torch_thread,
    random_game,
)

ROOT_VALUE_ATOL = 5e-5
SMALL = dict(channels=4, reduced_channels_reward=2, reduced_channels_value=2,
             reduced_channels_policy=2, num_simulations=12, root_exploration_fraction=0.0)


def _pair(game, **overrides):
    """(JAX config, runner, variables), (port config, network) with the
    same weights."""
    jcfg, cfg = jax_game(game).MuZeroConfig(), load_game_module(game).MuZeroConfig()
    for key, value in overrides.items():
        setattr(jcfg, key, value)
        setattr(cfg, key, value)
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.array, runner.init(jax.random.PRNGKey(5)))
    network = MuZeroNetwork(cfg, device="cpu")
    network.load_state_dict(params_from_jax(variables))
    return (jcfg, runner, variables), (cfg, network)


def assert_games_equal(got, want):
    for field in ("actions", "rewards", "to_play", "child_visits"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.observations.dtype == want.observations.dtype == np.float32
    np.testing.assert_allclose(got.observations, want.observations, rtol=0, atol=1e-6)
    assert got.root_values.dtype == np.float32
    np.testing.assert_allclose(got.root_values, want.root_values, rtol=0,
                               atol=ROOT_VALUE_ATOL)


@pytest.mark.parametrize("muzero_player", [0, 1])
def test_random_opponent_game_matches_jax(muzero_player, monkeypatch):
    deterministic_specs(monkeypatch)
    (jcfg, runner, variables), (cfg, network) = _pair("tictactoe", **SMALL)
    env = load_game_module("tictactoe").make_env(device="cpu")
    want = jax_evaluate.play_against_opponent(
        jax_game("tictactoe").make_env(), runner, jcfg, variables, "random", muzero_player,
        seed=3)
    got = evaluate.play_against_opponent(env, network, cfg, "random", muzero_player, seed=3)
    assert len(got) >= 5
    assert_games_equal(got, want)
    mine = got.to_play[:-1] == muzero_player
    assert (got.root_values[~mine] == 0).all() and (got.child_visits[~mine] == 0).all()
    np.testing.assert_allclose(got.child_visits[mine].sum(1), 1.0, rtol=1e-6)


def test_self_game_matches_jax_from_a_carried_start(monkeypatch):
    deterministic_specs(monkeypatch)
    (jcfg, runner, variables), (cfg, network) = _pair(
        "cartpole", num_simulations=10, max_moves=24, root_exploration_fraction=0.0)
    jenv = jax_game("cartpole").make_env()
    # JAX play_against_opponent's own start: reset(split(PRNGKey(seed))[1])
    _, k = jax.random.split(jax.random.PRNGKey(11))
    s = jenv.reset(k)
    start = np.array([float(s.x), float(s.x_dot), float(s.theta), float(s.theta_dot)],
                     np.float32)
    want = jax_evaluate.play_against_opponent(jenv, runner, jcfg, variables, "self", 0,
                                              seed=11)
    env = load_game_module("cartpole").make_env(device="cpu")
    got = evaluate.play_against_opponent(env, network, cfg, "self", 0, seed=11, start=start)
    assert len(got) == len(want) >= 8
    assert_games_equal(got, want)


def test_two_player_reward_split_matches_jax():
    rng = np.random.default_rng(4)
    cfg = load_game_module("tictactoe").MuZeroConfig()
    for length in (1, 4, 9):
        fields = random_game(rng, cfg, length)
        for player in (0, 1):
            assert two_player_reward_split(
                GameHistory(**fields), player) == jax_split(
                JaxGameHistory(**fields), player)


@pytest.mark.parametrize("muzero_player", [0, 1])
def test_test_mean_matches_jax(muzero_player, monkeypatch, tmp_path):
    """MuZero.test against the random opponent: the same games, so the same
    mean of MuZero's own rewards."""
    deterministic_specs(monkeypatch)
    overrides = dict(TICTACTOE, num_simulations=12, results_path=str(tmp_path))
    jmz = JaxMuZero("tictactoe", dict(overrides))
    mz = MuZero("tictactoe", dict(overrides), device="cpu")
    mz.checkpoint["weights"] = jax.tree_util.tree_map(np.array, jmz.checkpoint["weights"])
    want = jmz.test(opponent="random", muzero_player=muzero_player, num_tests=3)
    got = mz.test(opponent="random", muzero_player=muzero_player, num_tests=3)
    assert got == want


def test_self_test_runs_one_greedy_lane(tmp_path):
    """test() against "self": a one-lane driver at temperature 0, on an FC
    net the fused search; the mean of its games' rewards."""
    mz = MuZero("cartpole", dict(num_simulations=6, max_moves=15,
                                 results_path=str(tmp_path)), device="cpu")
    make_driver, drivers, plays = mz._make_driver, [], []

    def spy(network, **kw):
        driver = make_driver(network, **kw)
        play = driver.play

        def recorded(temperature, *a, **k):
            games, stats = play(temperature, *a, **k)
            plays.append((temperature, games))
            return games, stats

        driver.play = recorded
        drivers.append(driver)
        return driver

    mz._make_driver = spy
    result = mz.test(num_tests=2)
    (driver,) = drivers
    assert driver.G == 1 and driver.search_route == "fused"
    assert {t for t, _ in plays} == {0.0}
    games = [gh for _, batch in plays for gh in batch][:2]
    assert len(games) == 2
    assert result == float(np.mean([gh.rewards.sum() for gh in games]))


def test_expert_opponent_game(monkeypatch):
    """The connect4 expert (the env's batched expert on a one-game batch,
    drawn from a generator seeded with `seed`) plays legal moves to the end;
    the same seed gives the same game."""
    (_, _, _), (cfg, network) = _pair("connect4", channels=4, reduced_channels_reward=2,
                                      reduced_channels_value=2, reduced_channels_policy=2,
                                      num_simulations=4)
    env = load_game_module("connect4").make_env(device="cpu")
    games = [evaluate.play_against_opponent(env, network, cfg, "expert", 1, seed=2)
             for _ in range(2)]
    np.testing.assert_array_equal(games[0].actions, games[1].actions)
    gh = games[0]
    assert 7 <= len(gh) <= 42
    assert gh.rewards[1:].max() == 10.0  # someone won (the expert, against a 4-sim net)
    assert (gh.child_visits[gh.to_play[:-1] == 0] == 0).all()


# ---------------------------------------------------------------------------
# The envs' human-facing helpers (JAX envs/*.py)
# ---------------------------------------------------------------------------

GAMES = ["cartpole", "connect4", "gomoku", "simple_grid", "tictactoe"]


@pytest.mark.parametrize("game", GAMES)
def test_action_to_string_matches_jax(game):
    env = load_game_module(game).make_env(device="cpu")
    jenv = jax_game(game).make_env()
    strings = [env.action_to_string(a) for a in range(env.num_actions)]
    assert strings == [jenv.action_to_string(a) for a in range(jenv.num_actions)]
    assert strings == [env.action_to_string(np.int64(a)) for a in range(env.num_actions)]


BOARD_MOVES = {"tictactoe": [4, 0, 8], "connect4": [3, 3, 2, 6], "gomoku": [60, 61, 13]}


def _play_both(game):
    env = load_game_module(game).make_env(device="cpu")
    jenv = jax_game(game).make_env()
    state = env.reset(1)
    jstate = jenv.reset(jax.random.PRNGKey(0))
    for a in BOARD_MOVES[game]:
        state, _, _ = env.step(state, torch.tensor([a]))
        jstate, _, _ = jenv.step(jstate, a, jax.random.PRNGKey(0))
    return env, state, jenv, jstate


@pytest.mark.parametrize("game", list(BOARD_MOVES))
def test_render_and_human_input_match_jax(game, monkeypatch, capsys):
    env, state, jenv, jstate = _play_both(game)
    jenv.render(jstate)
    want = capsys.readouterr().out
    env.render(state)
    assert capsys.readouterr().out == want
    answers = {"tictactoe": ["x", "1", "1", "1", "2"],  # bad row, taken cell, then (1, 2)
               "connect4": ["9", "x", "5"], "gomoku": ["zz", "FF", "AB"]}[game]
    chosen = []
    for helper, s in ((jenv.human_to_action, jstate), (env.human_to_action, state)):
        feed = iter(answers)
        monkeypatch.setattr(builtins, "input", lambda prompt="": next(feed))
        chosen.append(int(helper(s)))
    assert chosen[0] == chosen[1]
    assert bool(env.legal_actions_mask(state)[0, chosen[1]])
