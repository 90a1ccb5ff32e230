"""The port's self-play driver against the JAX package's, move for move.

Both drivers run the same weights from the same cartpole start states (the
JAX driver's own draw, injected into the port), with deterministic search
(first-index ties), temperature 0 and no noise. Until a lane's first `done`
(after which each side resets from its own generator) the MoveRecord fields
must agree: actions and visit policies exactly, observations to 1e-5 (the env
check's tolerance), root values to 5e-5 (the search check's).
"""

import jax
import numpy as np
import pytest
import torch

from muzero_general_tpu.games.cartpole import MuZeroConfig as JaxConfig
from muzero_general_tpu.games.cartpole import make_env as jax_make_env
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.selfplay import SelfPlayDriver as JaxDriver
from muzero_general_tpu_torch.games.cartpole import MuZeroConfig, make_env
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from muzero_general_tpu_torch.selfplay import SelfPlayDriver


def _config(cls, G=8, sims=12, K=4):
    cfg = cls()
    cfg.num_simulations = sims
    cfg.parallel_games = G
    cfg.selfplay_chunk_moves = K
    return cfg


def _port_driver(cfg, seed=0, greedy_lanes=0, deterministic=False):
    net = MuZeroNetwork(cfg, device="cpu", seed=seed)
    driver = SelfPlayDriver(make_env(device="cpu"), net, cfg, seed=seed,
                            greedy_lanes=greedy_lanes, device="cpu")
    if deterministic:
        driver.fused_spec = driver.fused_spec._replace(tie_jitter=0.0)
    return driver


def test_driver_matches_jax_driver_until_first_done():
    G, K = 8, 40
    jcfg = _config(JaxConfig, G=G, K=K)
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, runner.init(jax.random.PRNGKey(2)))
    jd = JaxDriver(jax_make_env(), runner, jcfg, seed=0)
    assert not jd.use_fused  # the staged XLA search on the CPU
    jd.spec = jd.spec._replace(deterministic_tie_break=True)
    jd._build()
    jd._rng, k = jax.random.split(jd._rng)
    carry = jd._init_carry(jax.random.split(k, 1))
    s = carry.env_state
    start = np.stack([np.asarray(x) for x in (s.x, s.x_dot, s.theta, s.theta_dot)], -1)
    temps = np.zeros((G,), np.float32)
    _, want = jd._get_play_chunk(K, False)(variables, carry, temps)
    want = jax.tree_util.tree_map(np.asarray, want)

    driver = _port_driver(_config(MuZeroConfig, G=G, K=K), deterministic=True)
    driver.network.load_state_dict(params_from_jax(variables))
    driver.reset(start=torch.from_numpy(start))
    got = driver.play_chunk(torch.from_numpy(temps), K, add_noise=False)
    got = type(got)(*(f.numpy() for f in got))

    first_done = np.where(want.done.any(0), want.done.argmax(0), K - 1)
    live = np.arange(K)[:, None] <= first_done[None, :]  # [K, G]
    assert live.sum() >= 4 * G
    np.testing.assert_array_equal(got.done[live], want.done[live])
    np.testing.assert_array_equal(got.action[live], want.action[live])
    np.testing.assert_array_equal(got.child_visits[live], want.child_visits[live])
    np.testing.assert_array_equal(got.reward[live], want.reward[live])
    np.testing.assert_allclose(got.observation[live], want.observation[live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.root_value[live], want.root_value[live],
                               atol=5e-5, rtol=1e-5)
    np.testing.assert_allclose(got.pred_value[live], want.pred_value[live],
                               atol=1e-5, rtol=1e-5)


def test_driver_produces_consistent_histories():
    cfg = _config(MuZeroConfig, G=4, sims=8, K=16)
    cfg.max_moves = 12  # every lane finishes at least one episode
    driver = _port_driver(cfg)
    completed, stats = driver.play(temperature=1.0)
    assert stats["env_steps"] == 64
    assert len(completed) >= 4
    for gh in completed:
        L = len(gh)
        assert 1 <= L <= 12
        assert gh.observations.shape == (L, 1, 1, 4)
        assert gh.actions.shape == gh.rewards.shape == gh.to_play.shape == (L + 1,)
        assert gh.child_visits.shape == (L, 2)
        np.testing.assert_allclose(gh.child_visits.sum(-1), 1.0, rtol=1e-6)
        assert gh.actions[0] == 0 and gh.rewards[0] == 0
        assert np.all(gh.rewards[1:] == 1.0)


def test_greedy_eval_lanes_partitioned_and_seeded():
    cfg = _config(MuZeroConfig, G=4, sims=6, K=12)
    cfg.max_moves = 6
    runs = []
    for _ in range(2):
        driver = _port_driver(cfg, seed=3, greedy_lanes=1)
        completed, stats = driver.play(temperature=1.0)
        assert len(stats["eval_games"]) == 2  # lane 0 finished two 6-move games
        assert len(completed) == 6
        assert "eval_partial_reward" in stats
        runs.append([gh.actions for gh in completed + stats["eval_games"]])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_driver_rejects_what_is_not_ported():
    cfg = _config(MuZeroConfig)
    net = MuZeroNetwork(cfg, device="cpu")
    env = make_env(device="cpu")
    # "auto" runs the fused search on any device; the staged search is not ported.
    assert SelfPlayDriver(env, net, cfg, device="cpu").fused_spec.num_simulations == 12
    cfg.use_fused_search = False
    with pytest.raises(NotImplementedError, match="item 6"):
        SelfPlayDriver(env, net, cfg, device="cpu")
    cfg.use_fused_search = "auto"
    cfg.use_gumbel_mcts = True
    with pytest.raises(NotImplementedError, match="item 16"):
        SelfPlayDriver(env, net, cfg, device="cpu")
    cfg.use_gumbel_mcts = False
    cfg.network = "resnet"
    with pytest.raises(NotImplementedError, match="ResNet"):
        SelfPlayDriver(env, net, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        MuZeroNetwork(cfg, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    """device=None means CUDA; with no card it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    cfg = _config(MuZeroConfig)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MuZeroNetwork(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_env()
    net = MuZeroNetwork(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SelfPlayDriver(make_env(device="cpu"), net, cfg)
