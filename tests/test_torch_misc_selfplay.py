"""The port's self-play driver on the games this slice adds: gridworld (FC,
the fused search), twentyone (ResNet on 3 x 3) and breakout (the
downsampled ResNet on 96 x 96).

Gridworld's step is deterministic, so its driver is held against the JAX
driver move for move from the JAX driver's start states (half of them set
beside the goal) and its root noise (its own Gamma draws, repeated here
from its key splits), both injected into the port, with first-index ties
and temperature 0, as tests/test_torch_selfplay.py holds cartpole's (which
plays without noise): until a lane's first done,
actions, visit policies, done flags, observations and depths exactly, root
values to 5e-5. Rewards to one float32 ulp: the JAX driver is jitted, and
XLA folds the reward's 0.9 * steps / 144 into steps * (0.9 / 144) fused
into the subtraction (tests/test_torch_misc_envs.py).
The others play one chunk at small widths on the CPU, on the kernel route's
plain versions where the planar kernels take the tree, and must emit
consistent game histories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.games.gridworld import MuZeroConfig as JaxGridWorld
from muzero_general_tpu.games.gridworld import make_env as jax_gridworld_env
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.selfplay import SelfPlayDriver as JaxDriver
from muzero_general_tpu_torch.config import load_game_module
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from muzero_general_tpu_torch.ops import mcts as port_mcts
from muzero_general_tpu_torch.selfplay import SelfPlayDriver


def _config(game, **overrides):
    cfg = load_game_module(game).MuZeroConfig()
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


def test_gridworld_driver_matches_jax_driver_until_first_done(monkeypatch):
    G, K, sims = 8, 15, 10
    jcfg = JaxGridWorld()
    jcfg.parallel_games, jcfg.selfplay_chunk_moves, jcfg.num_simulations = G, K, sims
    runner = JaxNetwork(jcfg)
    # Weights whose greedy moves take all three actions: some random inits
    # (PRNGKey(4), PRNGKey(5)) turn left at every move, which would leave
    # the forward step and the goal out of the comparison.
    variables = jax.tree_util.tree_map(np.asarray, runner.init(jax.random.PRNGKey(3)))
    jd = JaxDriver(jax_gridworld_env(), runner, jcfg, seed=0)
    assert not jd.use_fused  # the staged XLA search on the CPU
    jd.spec = jd.spec._replace(deterministic_tie_break=True)
    jd._build()
    jd._rng, k = jax.random.split(jd._rng)
    carry = jd._init_carry(jax.random.split(k, 1))
    # Half the lanes start beside the goal (4, 4) so that goals are reached
    # within the chunk; the others keep the JAX driver's own draw.
    start = np.stack([np.asarray(carry.env_state.x), np.asarray(carry.env_state.y),
                      np.asarray(carry.env_state.dir)], -1)
    start[: G // 2] = [[3, 4, 0], [4, 3, 1], [3, 4, 3], [4, 3, 0]][: G // 2]
    states = carry.env_state._replace(**{
        name: jnp.asarray(start[:, i]) for i, name in enumerate(("x", "y", "dir"))})
    obs0 = jax.vmap(jax_gridworld_env().observation)(states)
    carry = carry._replace(env_state=states, obs_hist=carry.obs_hist.at[:, 0].set(obs0))
    temps = np.zeros((G,), np.float32)
    _, want = jd._get_play_chunk(K, True)(variables, carry, temps)
    want = jax.tree_util.tree_map(np.asarray, want)
    # The JAX driver's root noise: each move splits the carried key into
    # (rng, k_mcts, k_sel, k_step, k_reset), and run_mcts draws the Gammas
    # from fold_in(k_mcts, 0) (JAX selfplay.py:174-176, ops/mcts.py:1043).
    draws, rng = [], carry.rng[0]
    for _ in range(K):
        rng, k_mcts, _, _, _ = jax.random.split(rng, 5)
        draws.append(torch.from_numpy(np.array(jax.random.gamma(
            jax.random.fold_in(k_mcts, 0), jcfg.root_dirichlet_alpha, (G, 3)))))
    monkeypatch.setattr(port_mcts, "sample_gamma", lambda *a, **k: draws.pop(0))

    cfg = _config("gridworld", parallel_games=G, selfplay_chunk_moves=K, num_simulations=sims)
    net = MuZeroNetwork(cfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    module = load_game_module("gridworld")
    driver = SelfPlayDriver(module.make_env(device="cpu"), net, cfg, seed=0, device="cpu")
    assert driver.search_route == "fused"
    driver.fused_spec = driver.fused_spec._replace(tie_jitter=0.0)
    driver.reset(start=torch.from_numpy(start))
    got = driver.play_chunk(torch.from_numpy(temps), K, add_noise=True)
    got = type(got)(*(f.numpy() for f in got))
    assert not draws  # one injected draw a move

    first_done = np.where(want.done.any(0), want.done.argmax(0), K - 1)
    live = np.arange(K)[:, None] <= first_done[None, :]  # [K, G]
    assert live.sum() >= 4 * G and want.done.any(0).all()
    for name in ("done", "action", "child_visits", "observation", "max_tree_depth"):
        np.testing.assert_array_equal(getattr(got, name)[live], getattr(want, name)[live],
                                      err_msg=name)
    np.testing.assert_allclose(got.reward[live], want.reward[live], atol=6e-8, rtol=0)
    assert len(np.unique(want.action[live])) == 3
    assert (got.reward[live] > 0).any()  # goals reached on both sides
    np.testing.assert_allclose(got.root_value[live], want.root_value[live], atol=5e-5, rtol=0)
    np.testing.assert_allclose(got.pred_value[live], want.pred_value[live], atol=1e-5, rtol=0)


SMALL = {
    "twentyone": dict(parallel_games=8, num_simulations=8, selfplay_chunk_moves=8,
                      blocks=1, channels=8, use_pallas_mcts=True),
    "breakout": dict(parallel_games=8, num_simulations=4, selfplay_chunk_moves=6,
                     max_moves=3, blocks=1, channels=4, reduced_channels_reward=2,
                     reduced_channels_value=2, reduced_channels_policy=2,
                     use_pallas_mcts=True),
    "gridworld": dict(parallel_games=4, num_simulations=6, selfplay_chunk_moves=16),
}


@pytest.mark.parametrize("game", list(SMALL))
def test_driver_chunk_emits_consistent_histories(game):
    cfg = _config(game, **SMALL[game])
    net = MuZeroNetwork(cfg, device="cpu")
    driver = SelfPlayDriver(load_game_module(game).make_env(device="cpu"), net, cfg, seed=1,
                            device="cpu")
    # The planar kernels take these trees: their plain versions run here.
    assert driver.search_route == ("fused" if game == "gridworld" else "staged")
    assert driver.spec.use_kernels == (game != "gridworld")
    completed, stats = driver.play(temperature=1.0)
    assert stats["env_steps"] == cfg.parallel_games * cfg.selfplay_chunk_moves
    assert completed
    A = len(cfg.action_space)
    for gh in completed:
        L = len(gh)
        assert 1 <= L <= cfg.max_moves
        assert gh.observations.shape == (L,) + tuple(cfg.observation_shape)
        assert gh.child_visits.shape == (L, A)
        np.testing.assert_allclose(gh.child_visits.sum(-1), 1.0, rtol=1e-6)
        assert gh.actions[0] == 0 and gh.rewards[0] == 0
        assert np.isfinite(gh.root_values).all()
    rewards = np.concatenate([gh.rewards[1:] for gh in completed])
    if game == "twentyone":  # a reward only on the ending step, +-10 or 0
        assert set(np.unique(rewards)) <= {-10.0, 0.0, 10.0}
        assert all((gh.rewards[1:-1] == 0).all() for gh in completed)
    elif game == "gridworld":
        assert ((rewards >= 0) & (rewards < 1)).all()
