"""The port's orchestration on host envs (MuZero with lunarlander, evaluate.py
and diagnose.py on envs/host.py) and the shipped lunarlander checkpoint
against the JAX package's.

- MuZero("lunarlander", device="cpu") trains a few steps through the host
  driver and tests;
- an evaluation game against the random opponent on the fake two-player
  OpenSpiel game of tests/test_misc_envs.py, both packages from the same
  weights, first-index ties (deterministic_specs) and no root noise
  (root_exploration_fraction 0), the opponent's draws from
  np.random.default_rng(seed) on both sides: the same game, root values
  within 1e-4 (the 1 x 16 ResNet's tolerance, tests/test_torch_hostplay.py);
- the manual game and the diagnosis on host envs;
- the shipped pretrained/lunarlander/model.checkpoint in both packages:
  test() with the noise off and first-index ties plays the same first 50
  moves. The full-episode test rewards of both packages are printed by the
  slow test below (`--run-slow`), a quality record, not a gate.
"""

import builtins
import pathlib

import jax
import numpy as np
import pytest

from muzero_general_tpu import MuZero as JaxMuZero
from muzero_general_tpu import evaluate as jax_evaluate
from muzero_general_tpu import hostplay as jax_hostplay
from muzero_general_tpu.config import load_game_module as jax_game
from muzero_general_tpu.envs.host import SpielGame as JaxSpielGame
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu_torch import MuZero, checkpoint, evaluate, hostplay
from muzero_general_tpu_torch.config import load_game_module
from muzero_general_tpu_torch.envs.host import SpielGame
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from test_misc_envs import _FakeSpielGame
from test_torch_muzero import (  # noqa: F401 (one_torch_thread: a module fixture)
    deterministic_specs,
    no_plots,
    one_torch_thread,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PRETRAINED = REPO / "pretrained" / "lunarlander" / "model.checkpoint"
SPIEL = dict(observation_shape=(1, 1, 9), num_simulations=8, root_exploration_fraction=0.0)
LUNAR = dict(training_steps=4, batch_size=8, num_simulations=4, parallel_games=2,
             selfplay_chunk_moves=4, num_unroll_steps=3, td_steps=5, checkpoint_interval=2,
             max_moves=6, fused_train_steps=1, batch_prefetch=False)


def test_lunarlander_trains_and_tests_on_the_cpu(tmp_path):
    mz = MuZero("lunarlander", dict(LUNAR, results_path=str(tmp_path)), device="cpu")
    drivers = []
    make_driver = mz._make_driver

    def recording(*args, **kwargs):
        drivers.append(make_driver(*args, **kwargs))
        return drivers[-1]

    mz._make_driver = recording
    ck = mz.train(log_in_tensorboard=False)
    assert ck["training_step"] == 4 and ck["num_played_games"] >= 1
    assert np.isfinite(ck["total_loss"]) and ck["episode_length"] > 0
    assert (tmp_path / "model.checkpoint").exists()
    result = mz.test(num_tests=2)
    assert np.isfinite(result)
    assert [type(d) for d in drivers] == [hostplay.HostSelfPlayDriver] * 2
    assert [d.G for d in drivers] == [2, 1] and drivers[0].greedy_lanes == 1
    saved = checkpoint.load_checkpoint(tmp_path / "model.checkpoint")
    assert saved["training_step"] == 4


def _spiel_pair():
    jcfg, cfg = jax_game("spiel").MuZeroConfig(), load_game_module("spiel").MuZeroConfig()
    for c in (jcfg, cfg):
        for key, value in SPIEL.items():
            setattr(c, key, value)
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.array, runner.init(jax.random.PRNGKey(5)))
    network = MuZeroNetwork(cfg, device="cpu")
    network.load_state_dict(params_from_jax(variables))
    return (jcfg, runner, variables), (cfg, network)


@pytest.mark.parametrize("muzero_player", [0, 1])
def test_random_opponent_game_on_a_host_env_matches_jax(muzero_player, monkeypatch):
    deterministic_specs(monkeypatch)
    (jcfg, runner, variables), (cfg, network) = _spiel_pair()
    want = jax_evaluate.play_against_opponent(
        JaxSpielGame(game=_FakeSpielGame()), runner, jcfg, variables, "random", muzero_player,
        seed=3)
    got = evaluate.play_against_opponent(SpielGame(game=_FakeSpielGame()), network, cfg,
                                         "random", muzero_player, seed=3)
    assert len(got) == len(want) == 4
    for field in ("actions", "rewards", "to_play", "child_visits", "observations"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                      err_msg=field)
    np.testing.assert_allclose(got.root_values, want.root_values, atol=1e-4, rtol=0)
    mine = got.to_play[:-1] == muzero_player
    assert mine.any() and (~mine).any()
    assert (got.root_values[~mine] == 0).all() and (got.child_visits[~mine] == 0).all()


def test_manual_game_and_expert_on_a_host_env(monkeypatch, capsys):
    moves = iter(["0", "1", "2", "3"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(moves))
    evaluate.manual_game(SpielGame(game=_FakeSpielGame()))
    out = capsys.readouterr().out
    assert out.count("Reward:") == 4 and "Total reward: -1.0" in out
    (_, _, _), (cfg, network) = _spiel_pair()
    game = evaluate.play_against_opponent(SpielGame(game=_FakeSpielGame()), network, cfg,
                                          "expert", 0, seed=1)
    assert len(game) == 4 and set(game.actions[1:]) <= set(range(9))


def test_diagnose_model_on_a_host_env(monkeypatch, tmp_path):
    drawn = no_plots(monkeypatch)
    mz = MuZero("lunarlander", dict(LUNAR, results_path=str(tmp_path)), device="cpu")
    mz.make_env = lambda **kw: load_game_module("lunarlander").make_env(seed=2)
    virtual, real, divergence = mz.diagnose_model(horizon=3)
    assert len(virtual.action_history) == 3 and divergence is None
    assert real.action_history == virtual.action_history and len(real.mcts_depth) == 4
    assert all(np.isfinite(real.root_value_after_planning))
    assert drawn == ["mcts", "Virtual trajectory: ", "Real trajectory: "]


def _pretrained_games(monkeypatch, tmp_path, max_moves):
    """test() of the shipped checkpoint in both packages, the noise off and
    first-index ties; returns each package's (first game, test result)."""
    deterministic_specs(monkeypatch)
    out = {}
    packages = ((MuZero, hostplay.HostSelfPlayDriver, dict(device="cpu")),
                (JaxMuZero, jax_hostplay.HostSelfPlayDriver, {}))
    for cls, driver_cls, kwargs in packages:
        mz = cls("lunarlander", {"max_moves": max_moves, "root_exploration_fraction": 0.0,
                                 "results_path": str(tmp_path / cls.__module__)}, **kwargs)
        mz.load_model(checkpoint_path=PRETRAINED)
        games = []
        play = driver_cls.play

        def recording_play(self, *args, **kw):
            done, stats = play(self, *args, **kw)
            games.extend(done)
            return done, stats

        monkeypatch.setattr(driver_cls, "play", recording_play)
        result = mz.test(num_tests=1)
        out[cls.__module__.split(".")[0]] = games[0], result
    return out


def test_pretrained_lunarlander_first_moves_match_jax(monkeypatch, tmp_path):
    games = _pretrained_games(monkeypatch, tmp_path, max_moves=50)
    (got, result), (want, jresult) = games["muzero_general_tpu_torch"], games[
        "muzero_general_tpu"]
    assert len(got) == len(want) == 50
    np.testing.assert_array_equal(got.actions, want.actions)
    np.testing.assert_array_equal(got.child_visits, want.child_visits)
    np.testing.assert_allclose(got.root_values, want.root_values, atol=5e-5, rtol=0)
    np.testing.assert_allclose(got.rewards, want.rewards, atol=1e-6, rtol=0)
    assert result == pytest.approx(jresult, abs=1e-4)


@pytest.mark.slow
def test_pretrained_lunarlander_full_episode_rewards(monkeypatch, tmp_path):
    """The quality record of PERF.md: one full test() episode (the shipped
    max_moves, 700) of the shipped checkpoint in each package, the noise
    off. Printed, not gated (run with --run-slow -s)."""
    games = _pretrained_games(monkeypatch, tmp_path, max_moves=700)
    for package, (game, result) in games.items():
        print(f"[lunarlander pretrained] {package}: test() reward {result:.3f} over "
              f"{len(game)} moves")
    assert all(np.isfinite(result) for _, result in games.values())
