"""The port's model diagnosis (muzero_general_tpu_torch/diagnose.py) against
the JAX package's DiagnoseModel.

Both sides run the same weights, with the B = 1 search's ties broken at the
first index and no root noise (root_exploration_fraction 0, so the noise
draw cannot matter), as tests/test_torch_evaluate.py sets them; the real
trajectory starts from the JAX side's own start state (its first key
split), handed to the port. Every Trajectoryinfo list must then agree:
actions, visit policies and depths exactly, the network's priors to 1e-6,
root values to VALUE_ATOL = 5e-5 (tests/test_torch_evaluate.py's: float32
h^-1 quantizes leaf values, to ~3e-5 relative, and a root value averages
every simulation's), and the root's per-edge values and rewards, and the
decoded rewards of the virtual steps, to STAT_ATOL = 1e-3
(tests/test_torch_mcts.py's node statistics: an edge visited once keeps
one leaf decode's error, and the sum's terms cancel; observed 8.8e-5
on an edge value of 0.34).
"""

import jax
import numpy as np
import pytest
import torch

from muzero_general_tpu.config import load_game_module as jax_game
from muzero_general_tpu.diagnose import DiagnoseModel as JaxDiagnoseModel
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu_torch import MuZero
from muzero_general_tpu_torch.config import load_game_module
from muzero_general_tpu_torch.diagnose import DiagnoseModel
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from test_torch_muzero import (  # noqa: F401 (one_torch_thread: a module fixture)
    deterministic_specs,
    no_plots,
    one_torch_thread,
)

VALUE_ATOL, STAT_ATOL = 5e-5, 1e-3  # see the module docstring
EXACT = ("action_history", "policies_after_planning", "mcts_depth")
TOLERANCES = {"prior_policies": 1e-6, "prior_root_value": VALUE_ATOL,
              "root_value_after_planning": VALUE_ATOL, "values_after_planning": STAT_ATOL,
              "prior_rewards": STAT_ATOL, "reward_history": STAT_ATOL}
CASES = {
    "cartpole": dict(num_simulations=10, root_exploration_fraction=0.0),
    "tictactoe": dict(channels=4, reduced_channels_reward=2, reduced_channels_value=2,
                      reduced_channels_policy=2, num_simulations=12,
                      root_exploration_fraction=0.0),
}


def _pair(game):
    """(JAX config, runner, variables), (port config, network) with the same
    weights."""
    jcfg, cfg = jax_game(game).MuZeroConfig(), load_game_module(game).MuZeroConfig()
    for key, value in CASES[game].items():
        setattr(jcfg, key, value)
        setattr(cfg, key, value)
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.array, runner.init(jax.random.PRNGKey(3)))
    network = MuZeroNetwork(cfg, device="cpu")
    network.load_state_dict(params_from_jax(variables))
    return (jcfg, runner, variables), (cfg, network)


def assert_same_trajectory(got, want):
    for name in EXACT + tuple(TOLERANCES):
        a = np.array(getattr(got, name), np.float64)
        b = np.array(getattr(want, name), np.float64)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        if name in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=TOLERANCES[name], rtol=0, equal_nan=True,
                                       err_msg=name)


def _start(game, jenv, seed):
    """The JAX DiagnoseModel's real start state (its first split of
    PRNGKey(seed)), as the port's env.reset takes it; None where the env
    draws nothing."""
    if game != "cartpole":
        return None
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    s = jenv.reset(k)
    return np.array([float(s.x), float(s.x_dot), float(s.theta), float(s.theta_dot)],
                    np.float32)


@pytest.mark.parametrize("game", list(CASES))
def test_virtual_trajectory_from_obs_matches_jax(game, monkeypatch):
    deterministic_specs(monkeypatch)
    (jcfg, runner, variables), (cfg, network) = _pair(game)
    jenv = jax_game(game).make_env()
    obs = np.array(jenv.observation(jenv.reset(jax.random.PRNGKey(5))))
    want = JaxDiagnoseModel(runner, jcfg).get_virtual_trajectory_from_obs(
        variables, obs, 4, plot=False)
    dm = DiagnoseModel(network, cfg, "cpu")
    assert not dm.spec.use_kernels and not dm.spec.use_stream  # B = 1: plain-op route
    got = dm.get_virtual_trajectory_from_obs(torch.from_numpy(obs), 4, plot=False)
    assert len(got.action_history) == 4 and len(got.prior_policies) == 5
    assert_same_trajectory(got, want)


@pytest.mark.parametrize("game", list(CASES))
def test_compare_virtual_with_real_matches_jax(game, monkeypatch, tmp_path):
    deterministic_specs(monkeypatch)
    monkeypatch.chdir(tmp_path)  # JAX's plot_mcts renders into the working directory
    (jcfg, runner, variables), (cfg, network) = _pair(game)
    jenv = jax_game(game).make_env()
    want = JaxDiagnoseModel(runner, jcfg).compare_virtual_with_real_trajectories(
        variables, jenv, 3, plot=False)
    dm = DiagnoseModel(network, cfg, "cpu")
    env = load_game_module(game).make_env(device="cpu")
    got = dm.compare_virtual_with_real_trajectories(env, 3, plot=False,
                                                    start=_start(game, jenv, cfg.seed))
    assert got[2] == want[2]  # the divergence index
    for g, w in zip(got[:2], want[:2]):
        assert_same_trajectory(g, w)
    assert len(got[1].mcts_depth) >= 2


def test_plots_write_their_files(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # compare's own plot_mcts renders into the working directory
    (_, _, _), (cfg, network) = _pair("tictactoe")
    dm = DiagnoseModel(network, cfg, "cpu")
    env = load_game_module("tictactoe").make_env(device="cpu")
    virtual, real, _ = dm.compare_virtual_with_real_trajectories(env, 2, plot=False)
    for info in (virtual, real):
        info.plot_trajectory(save_dir=tmp_path, show=False)
    dm.close_all()
    pngs = sorted(p.name for p in tmp_path.glob("*.png"))
    assert "Virtual_trajectory_Prior_policies.png" in pngs
    assert "Real_trajectory_MCTS_depth.png" in pngs and len(pngs) == 18
    out = dm._search(env.observation(env.reset(1)))
    graph = dm.plot_mcts(out.tree, plot=False, filename=str(tmp_path / "mcts"))
    assert graph is not None and graph.source.count("Visit count") == 1 + int(
        (out.tree.children_visit[0] > 0).sum())
    # The dot binary renders a pdf; without it the DOT source is written.
    assert (tmp_path / "mcts.pdf").exists() or (tmp_path / "mcts.gv").exists()
    assert "Prior policies" in capsys.readouterr().out


@pytest.mark.parametrize("game", ["gridworld", "twentyone", "breakout"])
def test_diagnose_model_runs_on_the_new_games(game, monkeypatch, tmp_path):
    drawn = no_plots(monkeypatch)
    overrides = {"num_simulations": 4, "results_path": str(tmp_path)}
    if game == "breakout":
        overrides.update(blocks=1, channels=4, reduced_channels_reward=2,
                         reduced_channels_value=2, reduced_channels_policy=2)
    virtual, real, divergence = MuZero(game, overrides, device="cpu").diagnose_model(horizon=2)
    assert len(virtual.action_history) == 2 and divergence is None
    assert all(np.isfinite(virtual.root_value_after_planning + real.root_value_after_planning))
    assert drawn == ["mcts", "Virtual trajectory: ", "Real trajectory: "]
