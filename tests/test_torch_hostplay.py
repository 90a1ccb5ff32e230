"""The port's host-env self-play driver (muzero_general_tpu_torch/hostplay.py)
against the JAX package's, dispatch for dispatch.

Both drivers step the same host envs (lunarlander on gymnasium's Box2D with
the zero-dispersion engine, a fake OpenSpiel two-player game and Breakout
on a fake ALE backend, the stand-ins of tests/test_misc_envs.py) from the
same seeds, with the same weights (params_from_jax), the JAX search's
first-index ties (deterministic_tie_break, set from here), temperature 0
and the JAX driver's own root noise: each of its dispatches draws
gamma(fold_in(k, 0), alpha, (B, A)) from the key it hands the search
(JAX ops/mcts.py:1040-1049), which the port takes through
play(root_noise=...). The host envs reset from their own seeded
generators on both sides, so the drivers stay in step through episode
ends: every dispatch's stacked observations agree to 1e-5, its actions,
greedy actions, visit policies and depths exactly, and the completed games
and stats equal JAX's, with root values and the network's values within
VALUE_TOL of the setting:
- lunarlander (FC, support 10): root values 5e-5 (ROADMAP "Known
  tolerances", the h^-1 quantization of leaf values), the network's 1e-5;
- spiel (a 1 x 16 ResNet, BN folded, two players): 1e-4 for both, as
  tests/test_torch_selfplay.py holds tictactoe's driver (convs summed in
  another order, folded weights an rsqrt ulp apart; observed 7.0e-5);
- atari (the downsampled ResNet on 96 x 96 frames, support 300): 1e-4 of
  max(1, |value|): a float32 logit difference moves the support-300
  decode's sum by up to 300x as much, and h^-1's slope (~2|x|) magnifies
  that again (observed 4.6e-4 at a value of 13.9, 3.3e-5 relative).
Atari runs in float32 here (its shipped compute_dtype is bfloat16, whose
parity tests/test_torch_downsample.py holds for the same net).

One field differs on purpose: JAX's host driver appends a view of its
observation ring's slot 0 for each move (hostplay.py:170-173), which later
writes overwrite, so every observation of a completed JAX game reads the
game's last observation. The port records each move's observation; the
games' observations are held against the observations the JAX searches
received, and JAX's are checked to be that one repeated row.
"""

import jax
import numpy as np
import pytest
import torch

from muzero_general_tpu.config import load_game_module as jax_game
from muzero_general_tpu.envs.host import AtariBreakout as JaxAtariBreakout
from muzero_general_tpu.envs.host import SpielGame as JaxSpielGame
from muzero_general_tpu.hostplay import HostSelfPlayDriver as JaxHostDriver
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu_torch.config import load_game_module
from muzero_general_tpu_torch.envs.host import AtariBreakout, SpielGame
from muzero_general_tpu_torch.hostplay import HostSelfPlayDriver
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from test_misc_envs import _FakeALE, _FakeSpielGame
from test_torch_bf16 import _randomize_bn
from test_torch_muzero import one_torch_thread  # noqa: F401 (a module fixture)

OBS_ATOL = 1e-5
# (root values, the network's values): absolute, or relative to max(1, |v|)
VALUE_TOL = {"lunarlander": (5e-5, 1e-5, False), "spiel": (1e-4, 1e-4, False),
             "atari": (1e-4, 1e-4, True)}

# Each setting runs G lanes serially and 2G pipelined, so every dispatch
# searches G lanes and both JAX drivers run one compiled search.
SETTINGS = {
    # game module, overrides, (JAX env factory, port env factory) or None
    # for the module's make_env.
    "lunarlander": ("lunarlander", dict(parallel_games=2, num_simulations=8, max_moves=4),
                    None),
    "spiel": ("spiel", dict(parallel_games=2, num_simulations=8, observation_shape=(1, 1, 9)),
              (lambda seed=None: JaxSpielGame(game=_FakeSpielGame()),
               lambda seed=None: SpielGame(game=_FakeSpielGame()))),
    "atari": ("atari", dict(parallel_games=2, num_simulations=4, max_moves=3,
                            stacked_observations=2, blocks=1, channels=8,
                            reduced_channels_reward=4, reduced_channels_value=4,
                            reduced_channels_policy=4, resnet_fc_reward_layers=[8],
                            resnet_fc_value_layers=[8], resnet_fc_policy_layers=[8],
                            compute_dtype="float32"),
              (lambda seed=None: JaxAtariBreakout(seed=seed, env=_FakeALE()),
               lambda seed=None: AtariBreakout(seed=seed, env=_FakeALE()))),
}
CHUNKS, MOVES = 2, 3  # two play() calls of three moves


def _configs(setting, pipeline):
    game, overrides, _ = SETTINGS[setting]
    lanes = overrides["parallel_games"] * (2 if pipeline else 1)
    cfgs = []
    for cfg in (jax_game(game).MuZeroConfig(), load_game_module(game).MuZeroConfig()):
        for key, value in dict(overrides, host_pipeline=pipeline,
                               parallel_games=lanes).items():
            setattr(cfg, key, value)
        cfgs.append(cfg)
    return cfgs


def _factories(setting):
    game, _, factories = SETTINGS[setting]
    if factories is None:
        return jax_game(game).make_env, load_game_module(game).make_env
    return factories


def _lane_recorder(driver, lanes):
    finish = driver._finish

    def recording_finish(g, final_to_play):
        lanes.append(g)
        return finish(g, final_to_play)

    driver._finish = recording_finish


def _close(got, want, tol, relative, what):
    if relative:
        tol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def _run_jax(setting, pipeline, runner=None, search=None):
    """The JAX driver's two play() calls, its searches recorded. `runner`
    and `search`: the serial run's network and jitted search, which the
    pipelined driver shares (the same network, spec and dispatch batch, so
    the same function: one compile)."""
    jcfg, _ = _configs(setting, pipeline)
    runner = runner or JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, runner.init(jax.random.PRNGKey(5)))
    if "batch_stats" in variables:
        variables = _randomize_bn(variables, 6)  # the fold is not the identity
    jd = JaxHostDriver(_factories(setting)[0], runner, jcfg, seed=0, greedy_lanes=1)
    jd.spec = jd.spec._replace(deterministic_tie_break=True)
    if search is not None:
        jd._search = search
    calls, lanes = [], []
    search = jd._search

    def recording_search(variables, stacked, legal, to_play, temperature, key):
        out = search(variables, stacked, legal, to_play, temperature, key)
        calls.append({"stacked": np.asarray(stacked), "key": key,
                      "out": [np.asarray(x) for x in out]})
        return out

    jd._search = recording_search
    _lane_recorder(jd, lanes)
    chunks = [jd.play(variables, 0.0, num_moves=MOVES) for _ in range(CHUNKS)]
    return (variables, jcfg, calls, lanes, chunks), (runner, search)


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _jax(jax_runs, setting, pipeline):
    if (setting, False) not in jax_runs:
        jax_runs[setting, False] = _run_jax(setting, False)
    if (setting, pipeline) not in jax_runs:
        jax_runs[setting, pipeline] = _run_jax(setting, pipeline, *jax_runs[setting, False][1])
    return jax_runs[setting, pipeline][0]


@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_host_driver_matches_jax_driver(jax_runs, setting, pipeline, route):
    """route "kernels": the port's search on the planar descent and
    backprop kernels' route (their plain versions on the CPU), which the
    card takes for every host game's shipped shapes."""
    variables, jcfg, calls, jlanes, jchunks = _jax(jax_runs, setting, pipeline)
    _, cfg = _configs(setting, pipeline)
    G, A = cfg.parallel_games, len(cfg.action_space)
    root_tol, net_tol, relative = VALUE_TOL[setting]
    noises = [np.asarray(jax.random.gamma(jax.random.fold_in(c["key"], 0),
                                          jcfg.root_dirichlet_alpha,
                                          (c["stacked"].shape[0], A))) for c in calls]

    net = MuZeroNetwork(cfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    driver = HostSelfPlayDriver(_factories(setting)[1], net, cfg, seed=0, greedy_lanes=1,
                                device="cpu")
    assert not driver.spec.use_kernels  # "auto" on the CPU
    driver.spec = driver.spec._replace(deterministic_tie_break=True,
                                       use_kernels=route == "kernels")
    assert driver.fold_bn == ("batch_stats" in variables)
    assert driver.search_batch == SETTINGS[setting][1]["parallel_games"]
    records, lanes = [], []
    dispatch = driver._dispatch

    def recording_dispatch(net, lo, hi, *args):
        stacked = driver._stacked(lo, hi).numpy()
        out = dispatch(net, lo, hi, *args)
        records.append({"stacked": stacked, "lanes": (lo, hi), "out": out[0].numpy().copy()})
        return out

    driver._dispatch = recording_dispatch
    _lane_recorder(driver, lanes)
    fed = iter(noises)
    chunks = [driver.play(0.0, num_moves=MOVES, root_noise=lambda lo, hi: next(fed))
              for _ in range(CHUNKS)]
    assert next(fed, None) is None  # one injected draw a dispatch

    halves = 2 if pipeline else 1
    assert len(records) == len(calls) == CHUNKS * MOVES * halves
    for i, (got, want) in enumerate(zip(records, calls)):
        lo, hi = got["lanes"]
        assert hi - lo == G // halves and lo == (i % halves) * (G // halves)
        np.testing.assert_allclose(got["stacked"], want["stacked"], atol=OBS_ATOL, rtol=0)
        action, greedy, policy, root_value, pred_value, depth = want["out"]
        out = got["out"]
        np.testing.assert_array_equal(out[:, 0], action, err_msg=f"dispatch {i} action")
        np.testing.assert_array_equal(out[:, 1], greedy, err_msg=f"dispatch {i} greedy")
        np.testing.assert_array_equal(out[:, 2:2 + A], policy, err_msg=f"dispatch {i} policy")
        _close(out[:, 2 + A], root_value, root_tol, relative, f"dispatch {i} root value")
        _close(out[:, 3 + A], pred_value, net_tol, relative, f"dispatch {i} network value")
        np.testing.assert_array_equal(out[:, 4 + A], depth, err_msg=f"dispatch {i} depth")

    # Each lane's observation at each move, as the searches received them.
    C = cfg.observation_shape[0]
    seen = [[] for _ in range(G)]
    for i, want in enumerate(calls):
        lo = (i % halves) * (G // halves)
        for j, obs in enumerate(want["stacked"][:, :C]):
            seen[lo + j].append(obs)
    assert lanes == jlanes and lanes  # games finish in the same lanes, in the same order
    finished, start = iter(lanes), [0] * G
    for (games, stats), (jgames, jstats) in zip(chunks, jchunks):
        assert stats["env_steps"] == jstats["env_steps"] == MOVES * G
        assert stats["max_tree_depth"] == jstats["max_tree_depth"]
        _close(stats["pred_values"], jstats["pred_values"], net_tol, relative, "pred_values")
        assert stats["eval_partial_reward"] == pytest.approx(jstats["eval_partial_reward"],
                                                             abs=1e-6)
        assert len(games) == len(jgames)
        assert len(stats["eval_games"]) == len(jstats["eval_games"])
        sinks = {True: (iter(stats["eval_games"]), iter(jstats["eval_games"])),
                 False: (iter(games), iter(jgames))}
        for _ in range(len(games) + len(stats["eval_games"])):
            g = next(finished)
            got_sink, want_sink = sinks[g < driver.greedy_lanes]
            gh, jgh = next(got_sink), next(want_sink)
            for name in ("actions", "rewards", "to_play", "child_visits"):
                np.testing.assert_array_equal(getattr(gh, name), getattr(jgh, name),
                                              err_msg=name)
            _close(gh.root_values, jgh.root_values, root_tol, relative, "root_values")
            L = len(gh)
            want_obs = np.stack(seen[g][start[g]:start[g] + L])
            start[g] += L
            np.testing.assert_allclose(gh.observations, want_obs, atol=OBS_ATOL, rtol=0)
            # JAX's records: the game's last observation in every row.
            np.testing.assert_array_equal(jgh.observations,
                                          np.broadcast_to(jgh.observations[-1], want_obs.shape))
            np.testing.assert_allclose(jgh.observations[-1], want_obs[-1], atol=OBS_ATOL, rtol=0)
    assert any(c[0] for c in chunks) and any(c[1]["eval_games"] for c in chunks)


def _lunarlander_driver(seed=0, greedy_lanes=0, **overrides):
    _, cfg = _configs("lunarlander", overrides.pop("host_pipeline", False))
    for key, value in overrides.items():
        setattr(cfg, key, value)
    net = MuZeroNetwork(cfg, device="cpu", seed=seed)
    return HostSelfPlayDriver(load_game_module("lunarlander").make_env, net, cfg, seed=seed,
                              greedy_lanes=greedy_lanes, device="cpu")


@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])
def test_threshold_and_pipeline_per_lane_semantics(pipeline):
    """JAX tests/test_misc_envs.py:216-306 on the port: one search per lane
    per move (one G-lane dispatch a move, or two G/2-lane ones pipelined);
    past temperature_threshold (1: from each episode's second move; 0 and
    None mean no threshold, as in the reference) every action is the argmax
    of the same search's visit distribution; the records stay per-lane
    consistent."""
    driver = _lunarlander_driver(parallel_games=4, max_moves=8, temperature_threshold=1,
                                 host_pipeline=pipeline)
    K, G = 4, 4
    batches = []
    dispatch = driver._dispatch

    def counting_dispatch(net, lo, hi, *args):
        batches.append(hi - lo)
        return dispatch(net, lo, hi, *args)

    driver._dispatch = counting_dispatch
    _, stats = driver.play(1.0, num_moves=K)
    assert batches == [G // 2] * (2 * K) if pipeline else batches == [G] * K
    assert stats["env_steps"] == K * G and stats["pred_values"].shape == (G,)
    assert stats["max_tree_depth"] >= 1
    for g in range(G):
        p = driver._records[g]
        assert len(p["act"]) == len(p["cv"]) == len(p["rv"]) == len(p["obs"]) == K
        for cv, a in zip(p["cv"][1:], p["act"][1:]):
            assert a == int(np.argmax(cv))


def test_greedy_lanes_and_seeded_sampling():
    """Lanes below greedy_lanes play the greedy action at any temperature
    and their episodes arrive in stats["eval_games"]; the other lanes
    sample at temperature 1, and the same seed replays the same games."""
    runs = []
    for _ in range(2):
        driver = _lunarlander_driver(seed=3, greedy_lanes=1, parallel_games=3, max_moves=3)
        games, stats = driver.play(1.0, num_moves=7)
        assert len(stats["eval_games"]) == 2 and len(games) == 4  # 3-move games, 7 moves
        for gh in stats["eval_games"]:
            np.testing.assert_array_equal(gh.actions[1:], gh.child_visits.argmax(-1))
        open_eval = driver._records[0]
        assert stats["eval_partial_reward"] == pytest.approx(sum(open_eval["rew"]))
        for gh in games + stats["eval_games"]:
            assert gh.observations.shape == (len(gh), 1, 1, 8)
            assert not np.array_equal(gh.observations[0], gh.observations[-1])
        runs.append([gh.actions for gh in games])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(gh.actions[1:], gh.child_visits.argmax(-1))
               for gh in games)  # temperature 1 samples


def test_host_driver_refusals():
    class Mesh:
        shape = {"dp": 2, "mp": 1}

    _, cfg = _configs("lunarlander", False)
    net = MuZeroNetwork(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9b"):
        HostSelfPlayDriver(load_game_module("lunarlander").make_env, net, cfg, mesh=Mesh(),
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HostSelfPlayDriver(load_game_module("lunarlander").make_env, net, cfg)
