"""The port's gomoku path against the JAX package's: the env step for step,
the 6 x 128 ResNet at its full width, and the self-play driver on the
stream route move for move.

The env compares exactly: boards, players, done flags, rewards (1 on any
episode end, draws included: a reference quirk both keep), observations,
legal masks and player indices. The ResNet takes test_torch_resnet.py's
tolerance. The drivers run a 1 x 8 ResNet (random init, BN folded on both
sides) with deterministic ties, temperature 0 and no noise, the JAX driver's
spec forced to its stream kernels in interpret mode and the port's to its
stream route (their plain versions, on the CPU); at 12 simulations both
packages' from_config would pick another route. Until a lane's first done
actions, visits, depths and observations must be equal and values agree to
1e-4, as in the tictactoe driver test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.envs.gomoku import Gomoku as JaxGomoku
from muzero_general_tpu.envs.gomoku import GomokuState
from muzero_general_tpu.games.gomoku import MuZeroConfig as JaxConfig
from muzero_general_tpu.games.gomoku import make_env as jax_make_env
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.selfplay import SelfPlayDriver as JaxDriver
from muzero_general_tpu_torch.envs.board import BoardState
from muzero_general_tpu_torch.envs.gomoku import SIZE, Gomoku
from muzero_general_tpu_torch.games import AVAILABLE_GAMES
from muzero_general_tpu_torch.games.gomoku import MuZeroConfig, make_env
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from muzero_general_tpu_torch.ops import mcts as torch_mcts
from muzero_general_tpu_torch.selfplay import SelfPlayDriver

from test_torch_resnet import _compare, _randomize_bn


def test_gomoku_config_matches_jax_attribute_for_attribute():
    want, got = vars(JaxConfig()), vars(MuZeroConfig())
    assert set(want) <= set(got)  # the port's base config holds every knob
    for key, value in want.items():
        assert got[key] == value, key
    for trained, temp in ((0, 1.0), (5000, 0.5), (7500, 0.25)):
        assert MuZeroConfig().visit_softmax_temperature_fn(trained) == temp
        assert JaxConfig().visit_softmax_temperature_fn(trained) == temp
    assert "gomoku" in AVAILABLE_GAMES


def _jax_states(boards, players, done):
    return GomokuState(board=jnp.asarray(boards, jnp.int8),
                       player=jnp.asarray(players, jnp.int8), done=jnp.asarray(done))


def _assert_same(jenv, tenv, js, ts, j_rd=None, t_rd=None):
    np.testing.assert_array_equal(ts.board.numpy(), np.asarray(js.board))
    np.testing.assert_array_equal(ts.player.numpy(), np.asarray(js.player))
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    np.testing.assert_array_equal(tenv.observation(ts).numpy(),
                                  np.asarray(jax.vmap(jenv.observation)(js)))
    np.testing.assert_array_equal(tenv.legal_actions_mask(ts).numpy(),
                                  np.asarray(jax.vmap(jenv.legal_actions_mask)(js)))
    np.testing.assert_array_equal(tenv.to_play(ts).numpy(),
                                  np.asarray(jax.vmap(jenv.to_play)(js)))
    if j_rd is not None:
        for j, t in zip(j_rd, t_rd):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _play(moves, start=None):
    """Step both envs through `moves` [T, G] from empty boards (or `start`
    boards), comparing after every step; returns the last rewards and
    states."""
    jenv, tenv = JaxGomoku(), Gomoku(device="cpu")
    G = moves.shape[1]
    ts = tenv.reset(G, start=None if start is None else torch.from_numpy(start))
    js = _jax_states(ts.board.numpy(), ts.player.numpy(), ts.done.numpy())
    step = jax.jit(jax.vmap(jenv.step))
    keys = jax.random.split(jax.random.PRNGKey(0), G)
    for action in moves:
        js, j_r, j_d = step(js, jnp.asarray(action, jnp.int32), keys)
        ts, t_r, t_d = tenv.step(ts, torch.from_numpy(action))
        _assert_same(jenv, tenv, js, ts, (j_r, j_d), (t_r, t_d))
    return t_r, ts, tenv


def test_env_steps_match_jax_on_random_games():
    """Random legal games to the end and beyond: finished boards keep their
    done flag, pay nothing more and have no legal action."""
    G, rng = 32, np.random.default_rng(1)
    tenv = Gomoku(device="cpu")
    ts = tenv.reset(G)
    moves = []
    for _ in range(SIZE * SIZE // 2 + 8):
        legal = tenv.legal_actions_mask(ts).numpy()
        u = rng.random(legal.shape)
        action = np.argmax(np.where(legal | ~legal.any(1, keepdims=True), u, -1.0), 1)
        ts, _, _ = tenv.step(ts, torch.from_numpy(action))
        moves.append(action)
    reward, ts, tenv = _play(np.stack(moves))
    assert int(ts.done.sum()) >= 8  # fives were made
    assert not tenv.legal_actions_mask(ts)[ts.done].any()


def test_five_in_a_row_in_all_four_directions():
    """Player +1 lays five along a row, a column, a diagonal and an
    anti-diagonal (one game each) while -1 plays far away; the fifth stone
    ends the game with reward 1, and the next step pays nothing."""
    lines = {"row": [(5, c) for c in range(2, 7)], "column": [(r, 3) for r in range(1, 6)],
             "diagonal": [(i, i) for i in range(4, 9)],
             "anti-diagonal": [(8 - i, 2 + i) for i in range(5)]}
    others = [(10, 10), (10, 8), (0, 10), (10, 6)]
    moves = []
    for i in range(5):
        moves.append([r * SIZE + c for r, c in (line[i] for line in lines.values())])
        if i < 4:
            moves.append([others[i][0] * SIZE + others[i][1]] * len(lines))
    moves.append([0] * len(lines))  # a step after the end
    moves = np.array(moves)
    reward, ts, tenv = _play(moves[:-1])
    assert reward.tolist() == [1.0] * 4 and ts.done.all()
    reward, ts, _ = _play(moves)
    assert reward.tolist() == [0.0] * 4 and ts.done.all()


def _draw_board():
    """A full board with no five in a row in any direction: 61 stones of +1
    and 60 of -1, in diagonal bands two cells wide."""
    r, c = np.mgrid[:SIZE, :SIZE]
    return np.where(((2 * r + c) // 2) % 2 == 0, 1, -1).astype(np.int8)


def test_full_board_draw_pays_one():
    """The last empty cell filled without a five: done, and reward 1 (the
    reference quirk), as in the JAX env."""
    full = _draw_board()
    assert (full == 1).sum() == 61
    last = int(np.flatnonzero(full.reshape(-1) == 1)[30])
    start = full.copy().reshape(-1)
    start[last] = 0
    start = start.reshape(1, SIZE, SIZE)
    reward, ts, tenv = _play(np.array([[last]]), start=start)
    assert float(reward[0]) == 1.0 and bool(ts.done[0])
    assert np.array_equal(ts.board[0].numpy(), full)
    assert not tenv.legal_actions_mask(ts).any()


def test_action_to_string_matches_jax():
    env, jenv = Gomoku(device="cpu"), JaxGomoku()
    for a in (0, 13, 60, 120):
        assert env.action_to_string(a) == jenv.action_to_string(a)
    assert env.action_to_string(13) == "BC"


def test_resnet_full_width_matches_jax():
    """The shipped gomoku network, 6 blocks x 128 channels and A = 121,
    random init with random BN statistics: folded and unfolded against the
    JAX NetworkRunner at B = 2."""
    jcfg, tcfg = JaxConfig(), MuZeroConfig()
    assert (tcfg.blocks, tcfg.channels, len(tcfg.action_space)) == (6, 128, 121)
    variables = jax.tree_util.tree_map(np.asarray, JaxNetwork(jcfg).init(jax.random.PRNGKey(8)))
    _compare(jcfg, tcfg, _randomize_bn(variables, 9), seed=10, B=2)


def _small(cls, G, sims, K):
    cfg = cls()
    cfg.blocks, cfg.channels = 1, 8
    cfg.num_simulations = sims
    cfg.parallel_games = G
    cfg.selfplay_chunk_moves = K
    return cfg


def test_driver_on_the_stream_route_matches_jax_driver_until_first_done():
    G, K, sims = 8, 10, 12
    jcfg = _small(JaxConfig, G, sims, K)
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, runner.init(jax.random.PRNGKey(5)))
    jd = JaxDriver(jax_make_env(), runner, jcfg, seed=0)
    assert not jd.use_fused and not jd.spec.use_pallas and jd.fold_bn
    jd.spec = jd.spec._replace(deterministic_tie_break=True, use_stream=True,
                               pallas_interpret=True)
    jd._build()
    jd._rng, k = jax.random.split(jd._rng)
    carry = jd._init_carry(jax.random.split(k, 1))
    temps = np.zeros((G,), np.float32)
    _, want = jd._get_play_chunk(K, False)(variables, carry, temps)
    want = jax.tree_util.tree_map(np.asarray, want)

    cfg = _small(MuZeroConfig, G, sims, K)
    net = MuZeroNetwork(cfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    driver = SelfPlayDriver(make_env(device="cpu"), net, cfg, seed=0, device="cpu")
    assert not driver.use_fused and driver.fold_bn and not driver.spec.use_stream
    driver.spec = driver.spec._replace(deterministic_tie_break=True, use_stream=True)
    got = driver.play_chunk(torch.from_numpy(temps), K, add_noise=False)
    got = type(got)(*(f.numpy() for f in got))

    first_done = np.where(want.done.any(0), want.done.argmax(0), K - 1)
    live = np.arange(K)[:, None] <= first_done[None, :]  # [K, G]
    assert live.sum() >= 5 * G
    for name in ("done", "action", "child_visits", "reward", "to_play", "to_play_next",
                 "max_tree_depth", "observation"):
        np.testing.assert_array_equal(getattr(got, name)[live], getattr(want, name)[live],
                                      err_msg=name)
    for name in ("root_value", "pred_value"):
        np.testing.assert_allclose(getattr(got, name)[live], getattr(want, name)[live],
                                   atol=1e-4, rtol=0, err_msg=name)
    assert (got.child_visits.sum(-1) > 0.999).all()


def test_full_size_gomoku_routes_to_the_stream_kernels():
    """The shipped config at the bench's 64 lanes: the stream route on the
    card, as JAX's from_config routes it; the plain-op route on the CPU
    unless asked."""
    cfg = MuZeroConfig()
    spec = torch_mcts.SearchSpec.from_config(cfg, 64, "cuda")
    assert spec.use_stream and not spec.use_kernels and not spec.capture_path_stats
    assert not torch_mcts.SearchSpec.from_config(cfg, 64, "cpu").use_stream
    assert not torch_mcts.SearchSpec.from_config(cfg, 4, "cuda").use_stream  # eval lanes
    cfg.use_stream_mcts = False
    assert not torch_mcts.SearchSpec.from_config(cfg, 64, "cuda").use_stream
    jcfg = JaxConfig()
    jcfg.use_pallas_mcts = jcfg.use_stream_mcts = True
    from muzero_general_tpu.ops import mcts as jax_mcts
    assert jax_mcts.SearchSpec.from_config(jcfg, batch_size=64).use_stream


@pytest.mark.parametrize("start_player", [1, -1])
def test_reset_from_boards_sets_the_player(start_player):
    board = np.zeros((1, SIZE, SIZE), np.int8)
    if start_player == -1:
        board[0, 5, 5] = 1
    ts = Gomoku(device="cpu").reset(1, start=torch.from_numpy(board))
    assert isinstance(ts, BoardState) and int(ts.player[0]) == start_player
