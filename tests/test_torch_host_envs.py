"""The port's host envs (muzero_general_tpu_torch/envs/host.py) and the
lunarlander, atari and spiel game modules against the JAX package's.

Both packages wrap the same backends in numpy, so everything here is
exact: LunarLander on gymnasium's Box2D (the zero-dispersion engine and the
stock one) from the same seeds through a fixed action sequence; Breakout's
preprocessing (cv2 INTER_AREA to 96 x 96, /255, CHW) on the fake ALE
backend of tests/test_misc_envs.py; the OpenSpiel wrapper on its fake
two-player game; the configs attribute for attribute (lunarlander's
annealed `ratio` and every temperature schedule by value); and the
ImportErrors where ale-py and pyspiel are missing.
"""

import importlib.util

import numpy as np
import pytest

from muzero_general_tpu.config import load_game_module as jax_game
from muzero_general_tpu.envs import host as jax_host
from muzero_general_tpu_torch.config import load_game_module
from muzero_general_tpu_torch.envs import host
from test_misc_envs import _FakeALE, _FakeSpielGame

GAMES = ["lunarlander", "atari", "spiel"]


@pytest.mark.parametrize("deterministic", [True, False], ids=["zero_dispersion", "stock"])
def test_lunarlander_matches_jax_step_for_step(deterministic):
    """Three seeds, 300 steps each of one fixed action sequence, through
    the episodes' ends and resets: observations, rewards and done flags
    equal."""
    pytest.importorskip("gymnasium")
    actions = np.random.default_rng(0).integers(0, 4, 300)
    dones = 0
    for seed in (0, 1, 7):
        env = load_game_module("lunarlander").make_env(seed=seed, deterministic=deterministic,
                                                       device="cpu")
        jenv = jax_game("lunarlander").make_env(seed=seed, deterministic=deterministic)
        assert isinstance(env, host.LunarLander) and env.host_env
        obs, jobs = env.reset(), jenv.reset()
        assert obs.shape == env.observation_shape == (1, 1, 8) and obs.dtype == np.float32
        np.testing.assert_array_equal(obs, jobs)
        for a in actions:
            got, want = env.step(a), jenv.step(a)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:] and type(got[1]) is float and type(got[2]) is bool
            if got[2]:
                dones += 1
                np.testing.assert_array_equal(env.reset(), jenv.reset())
        assert env.legal_actions_mask().tolist() == [True] * 4 and env.to_play() == 0
        assert [env.action_to_string(a) for a in range(4)] == [
            jenv.action_to_string(a) for a in range(4)]
        env.close()
        jenv.close()
    assert dones >= 3  # every seed's lander lands or crashes within 300 steps


def test_zero_dispersion_engine_is_deterministic():
    """The swap of np_random around step (JAX envs/host.py:95-108): the same
    seed replays bit for bit, the stock engine's dispersion draws do not."""
    pytest.importorskip("gymnasium")

    def rollout(deterministic, n=60):
        env = host.LunarLander(seed=3, deterministic=deterministic)
        env.reset()
        out = [env.step(2)[0] for _ in range(n)]
        env.close()
        return np.stack(out)

    np.testing.assert_array_equal(rollout(True), rollout(True))
    assert not np.array_equal(rollout(True), rollout(False))
    real = object()
    zero = host._ZeroUniformRNG(real)
    assert zero.uniform(-1, 1, size=2) == 0.0 and zero.__class__ is host._ZeroUniformRNG


def test_atari_preprocessing_matches_jax_on_the_fake_ale():
    pytest.importorskip("cv2")
    env = host.AtariBreakout(seed=4, env=_FakeALE())
    jenv = jax_host.AtariBreakout(seed=4, env=_FakeALE())
    obs, jobs = env.reset(), jenv.reset()
    assert obs.shape == env.observation_shape == (3, 96, 96) and obs.dtype == np.float32
    np.testing.assert_array_equal(obs, jobs)
    assert 0.0 <= obs.min() and obs.max() <= 1.0
    done, steps = False, 0
    while not done:
        got, want = env.step(steps % 4), jenv.step(steps % 4)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        done, steps = got[2], steps + 1
    assert steps == 6  # the fake ALE's episode length
    frame = _FakeALE()._frame()
    np.testing.assert_array_equal(env._preprocess(frame), jenv._preprocess(frame))


def test_spiel_wrapper_matches_jax_on_the_fake_game():
    env, jenv = host.SpielGame(game=_FakeSpielGame()), jax_host.SpielGame(game=_FakeSpielGame())
    assert (env.observation_shape, env.num_actions, env.num_players) == (
        jenv.observation_shape, jenv.num_actions, jenv.num_players) == ((1, 1, 9), 9, 2)
    np.testing.assert_array_equal(env.reset(), jenv.reset())
    rng = np.random.default_rng(2)
    done = False
    while not done:
        mask = env.legal_actions_mask()
        np.testing.assert_array_equal(mask, jenv.legal_actions_mask())
        assert env.to_play() == jenv.to_play()
        a = env.expert_action(np.random.default_rng(int(rng.integers(9))))
        assert mask[a]
        got, want = env.step(a), jenv.step(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        done = got[2]
    assert got[1] == -1.0  # the 4th move is player 1's: its return


@pytest.mark.parametrize("game", GAMES)
def test_configs_match_jax_attribute_for_attribute(game):
    cfg, jcfg = load_game_module(game).MuZeroConfig(), jax_game(game).MuZeroConfig()
    mine, theirs = vars(cfg), vars(jcfg)
    assert mine.keys() == theirs.keys()
    for key in mine:
        if callable(mine[key]):  # lunarlander's annealed ratio
            assert callable(theirs[key])
            for games in (0, 1, 100, 249, 250, 251, 10_000):
                assert mine[key](games) == theirs[key](games), key
        else:
            assert mine[key] == theirs[key], key
    for step in (0, 1, 0.5 * cfg.training_steps, 0.8 * cfg.training_steps, 500e3, 800e3):
        assert cfg.visit_softmax_temperature_fn(step) == jcfg.visit_softmax_temperature_fn(step)


@pytest.mark.skipif(importlib.util.find_spec("ale_py") is not None
                    or importlib.util.find_spec("pyspiel") is not None,
                    reason="ale-py or pyspiel is installed here")
def test_missing_backends_raise_jax_import_errors():
    for make, jmake in ((load_game_module("atari").make_env, jax_game("atari").make_env),
                        (load_game_module("spiel").make_env, jax_game("spiel").make_env)):
        with pytest.raises(ImportError) as got:
            make(seed=0, device="cpu")
        with pytest.raises(ImportError) as want:
            jmake(seed=0)
        assert str(got.value) == str(want.value)
    assert "ale-py" in str(pytest.raises(ImportError, host.AtariBreakout).value)
    assert "pyspiel" in str(pytest.raises(ImportError, host.SpielGame).value)
