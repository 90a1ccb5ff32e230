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
from muzero_general_tpu.games.tictactoe import MuZeroConfig as JaxTicTacToeConfig
from muzero_general_tpu.games.tictactoe import make_env as jax_tictactoe_env
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.selfplay import SelfPlayDriver as JaxDriver
from muzero_general_tpu_torch.games.cartpole import MuZeroConfig, make_env
from muzero_general_tpu_torch.games.tictactoe import MuZeroConfig as TicTacToeConfig
from muzero_general_tpu_torch.games.tictactoe import make_env as tictactoe_env
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from muzero_general_tpu_torch.ops import mcts_fused
from muzero_general_tpu_torch.selfplay import SelfPlayDriver, search_route


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
    # FC nets: "auto" runs the fused search on any device, False the staged one.
    assert SelfPlayDriver(env, net, cfg, device="cpu").use_fused
    cfg.use_fused_search = False
    driver = SelfPlayDriver(env, net, cfg, device="cpu")
    assert not driver.use_fused and not driver.spec.use_kernels
    cfg.use_fused_search = "auto"
    # The Gumbel search is ported (tests/test_torch_gumbel.py): it takes the
    # staged route on any device, as the JAX driver turns its fused search
    # off under Gumbel.
    cfg.use_gumbel_mcts = True
    driver = SelfPlayDriver(env, net, cfg, device="cpu")
    assert (driver.search_route, driver.use_fused, driver.use_gumbel) == ("staged", False, True)
    assert search_route(cfg, torch.device("cuda")) == "staged"
    cfg.use_gumbel_mcts = False
    # Multi-leaf rounds: FC nets on the fused search ignore K, as the JAX
    # driver does; the staged search takes it.
    cfg.search_batch_leaves = 2
    driver = SelfPlayDriver(env, net, cfg, device="cpu")
    assert driver.use_fused and driver.spec.batch_leaves == 2
    _, stats = driver.play(temperature=1.0, num_moves=2)
    assert stats["env_steps"] == 2 * cfg.parallel_games
    cfg.use_fused_search = False
    driver = SelfPlayDriver(env, net, cfg, device="cpu")
    assert not driver.use_fused and driver.spec.batch_leaves == 2
    rec = driver.play_chunk(1.0, 2)
    assert bool((rec.child_visits.sum(-1) - 1).abs().max() < 1e-5)
    cfg.use_fused_search = "auto"
    cfg.search_batch_leaves = 1
    # bfloat16 search activations are ported (tests/test_torch_bf16.py).
    cfg.search_bf16_activations = True
    assert SelfPlayDriver(env, net, cfg, device="cpu").act_dtype == torch.bfloat16
    cfg.search_bf16_activations = False
    # Trees the planar kernels cannot take go to the stream kernels, as in
    # the JAX package.
    gcfg = _config(MuZeroConfig, G=16, sims=400)
    gcfg.action_space = list(range(121))
    gcfg.use_pallas_mcts = gcfg.use_stream_mcts = True
    gspec = SelfPlayDriver(env, net, gcfg, device="cpu").spec
    assert gspec.use_stream and not gspec.use_kernels
    tcfg = TicTacToeConfig()
    tcfg.downsample = "FFT"  # "resnet" and "CNN" are ported; others raise JAX's message
    with pytest.raises(NotImplementedError, match='downsample should be "resnet" or "CNN"'):
        MuZeroNetwork(tcfg, device="cpu")
    tcfg.downsample = False
    tcfg.compute_dtype = "bfloat16"
    assert MuZeroNetwork(tcfg, device="cpu").dtype == torch.bfloat16


def test_resnet_driver_matches_jax_driver_until_first_done():
    """Tictactoe with its shipped 1 x 16 ResNet (random init, BN folded on
    both sides): the staged search's plain-op route against the JAX driver's
    XLA path, move for move, deterministic ties, temperature 0, no noise.
    Values to 1e-4: the ResNet's convs sum in another order (tests/
    test_torch_resnet.py) and the support decode adds its rounding."""
    G, K = 8, 9
    jcfg = _config(JaxTicTacToeConfig, G=G, sims=25, K=K)
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, runner.init(jax.random.PRNGKey(3)))
    jd = JaxDriver(jax_tictactoe_env(), runner, jcfg, seed=0)
    assert not jd.use_fused and not jd.spec.use_pallas and jd.fold_bn
    jd.spec = jd.spec._replace(deterministic_tie_break=True)
    jd._build()
    jd._rng, k = jax.random.split(jd._rng)
    carry = jd._init_carry(jax.random.split(k, 1))
    temps = np.zeros((G,), np.float32)
    _, want = jd._get_play_chunk(K, False)(variables, carry, temps)
    want = jax.tree_util.tree_map(np.asarray, want)

    cfg = _config(TicTacToeConfig, G=G, sims=25, K=K)
    net = MuZeroNetwork(cfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    driver = SelfPlayDriver(tictactoe_env(device="cpu"), net, cfg, seed=0, device="cpu")
    assert not driver.use_fused and not driver.spec.use_kernels and driver.fold_bn
    driver.spec = driver.spec._replace(deterministic_tie_break=True)
    got = driver.play_chunk(torch.from_numpy(temps), K, add_noise=False)
    got = type(got)(*(f.numpy() for f in got))

    first_done = np.where(want.done.any(0), want.done.argmax(0), K - 1)
    live = np.arange(K)[:, None] <= first_done[None, :]  # [K, G]
    assert live.sum() >= 5 * G and want.done.any(0).all()
    for name in ("done", "action", "child_visits", "reward", "to_play", "to_play_next",
                 "max_tree_depth", "observation"):
        np.testing.assert_array_equal(getattr(got, name)[live], getattr(want, name)[live],
                                      err_msg=name)
    for name in ("root_value", "pred_value"):
        np.testing.assert_allclose(getattr(got, name)[live], getattr(want, name)[live],
                                   atol=1e-4, rtol=0, err_msg=name)


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


def _smem_bytes_transcribed(cfg, lanes):
    """csrc/mcts_fused.cu mcts_fused_search's shared-memory size, line for
    line, from the cartpole config's layer widths."""
    E, A, S2 = cfg.encoding_size, len(cfg.action_space), 2 * cfg.support_size + 1
    dims = [(E + A, 16), (16, E), (E, 16), (16, S2), (E, 16), (16, A), (E, 16), (16, S2)]
    n_weights, maxw = 0, 0
    for fan_in, fan_out in dims:
        n_weights += fan_in * fan_out + fan_out
        maxw = max(maxw, fan_in, fan_out)
    N = cfg.num_simulations + 1
    weight_words = (n_weights + 3) & ~3
    table_n = cfg.num_simulations + 2
    soft_width = S2 if S2 > A else A
    lane_words = (5 * N + 2 * N * A + N * E + A + E + 6 * maxw + 3 * soft_width + 7 + 3) & ~3
    tables_words = (table_n * 3 + 3) & ~3
    return 4 * (weight_words + tables_words + lanes * lane_words)


# The largest cartpole search the kernel's block of four lanes (one a warp)
# fits in 227 KB: 784 simulations (232,240 bytes); 785 take 232,512.
CARTPOLE_FUSED_MAX_SIMS = 784


@pytest.mark.parametrize("sims", [50, CARTPOLE_FUSED_MAX_SIMS, CARTPOLE_FUSED_MAX_SIMS + 1, 1000])
def test_fused_size_rule_matches_the_kernel_and_routes_big_searches_to_staged(sims):
    cfg = _config(MuZeroConfig, sims=sims)
    assert mcts_fused.fc_search_dims(cfg) == mcts_fused.fused_weights(
        MuZeroNetwork(cfg, device="cpu"), cfg.encoding_size).dims
    for lanes in (4, 8):
        assert mcts_fused.smem_bytes(
            mcts_fused.fc_search_dims(cfg), sims, 2, cfg.encoding_size, cfg.support_size,
            lanes) == _smem_bytes_transcribed(cfg, lanes)
    fits = _smem_bytes_transcribed(cfg, 4) <= 227 * 1024
    assert fits == (sims <= CARTPOLE_FUSED_MAX_SIMS) == mcts_fused.fits_kernel(cfg)
    # On the card the route follows the rule; on the CPU the plain version
    # has no limit. Every ResNet and use_fused_search=False run staged.
    assert search_route(cfg, torch.device("cuda")) == ("fused" if fits else "staged")
    assert search_route(cfg, torch.device("cpu")) == "fused"
    cfg.use_fused_search = False
    assert search_route(cfg, torch.device("cpu")) == "staged"
    assert search_route(_config(TicTacToeConfig, sims=sims), torch.device("cuda")) == "staged"


def test_driver_records_its_route_and_plays_on_it():
    cfg = _config(MuZeroConfig, G=4, sims=8, K=2)
    cfg.use_fused_search = False
    driver = _port_driver(cfg)
    assert (driver.search_route, driver.use_fused) == ("staged", False)
    _, stats = driver.play(temperature=1.0)
    assert stats["env_steps"] == 8 and stats["max_tree_depth"] >= 1
    assert _port_driver(_config(MuZeroConfig)).search_route == "fused"
