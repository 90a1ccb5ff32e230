"""The port's batched board envs (envs/tictactoe.py, envs/connect4.py)
against the JAX package's, step for step from the same actions.

Both sides play the same random legal games, drawn with numpy; every step's
board, player, done flag, reward, observation, legal mask and player index
must be equal. The expert heuristic is compared on the JAX tests' positions
(tests/test_board_envs.py) and on positions from random play wherever the
JAX expert's answer does not depend on its key (a win or a block; its
random fallback draws from JAX's generator, the port's from torch's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.envs.connect4 import Connect4 as JaxConnect4
from muzero_general_tpu.envs.connect4 import Connect4State
from muzero_general_tpu.envs.tictactoe import TicTacToe as JaxTicTacToe
from muzero_general_tpu_torch.envs.board import BoardState
from muzero_general_tpu_torch.envs.connect4 import Connect4
from muzero_general_tpu_torch.envs.tictactoe import TicTacToe

ENVS = {"tictactoe": (JaxTicTacToe, TicTacToe), "connect4": (JaxConnect4, Connect4)}


def _random_games(name, G, seed, max_plies=None):
    """Play G random legal games on both sides; yield the per-step states."""
    jenv, tenv = ENVS[name][0](), ENVS[name][1](device="cpu")
    rng = np.random.default_rng(seed)
    keys = jax.random.split(jax.random.PRNGKey(0), G)
    js = jax.vmap(jenv.reset)(keys)
    ts = tenv.reset(G)
    step = jax.jit(jax.vmap(jenv.step))
    plies = max_plies or tenv.observation_shape[1] * tenv.observation_shape[2]
    for _ in range(plies):
        legal = np.asarray(jax.vmap(jenv.legal_actions_mask)(js))
        u = rng.random(legal.shape)
        action = np.argmax(np.where(legal | ~legal.any(1, keepdims=True), u, -1.0), 1)
        js, j_r, j_d = step(js, jnp.asarray(action, jnp.int32), keys)
        ts, t_r, t_d = tenv.step(ts, torch.from_numpy(action))
        yield jenv, tenv, js, ts, (j_r, j_d), (t_r, t_d)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_steps_match_jax(name):
    finished = 0
    for jenv, tenv, js, ts, (j_r, j_d), (t_r, t_d) in _random_games(name, 64, seed=1):
        np.testing.assert_array_equal(ts.board.numpy(), np.asarray(js.board))
        np.testing.assert_array_equal(ts.player.numpy(), np.asarray(js.player))
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(tenv.observation(ts).numpy(),
                                      np.asarray(jax.vmap(jenv.observation)(js)))
        np.testing.assert_array_equal(tenv.legal_actions_mask(ts).numpy(),
                                      np.asarray(jax.vmap(jenv.legal_actions_mask)(js)))
        np.testing.assert_array_equal(tenv.to_play(ts).numpy(),
                                      np.asarray(jax.vmap(jenv.to_play)(js)))
        finished = int(ts.done.sum())
    assert finished >= 16  # wins, and for tictactoe full boards, were reached


_EXPERTS = {}  # one jitted batched JAX expert per env class


def _jax_expert_if_fixed(jenv, js, n_keys=8):
    """The JAX expert's action per game, or -1 where it varies with the key."""
    expert = _EXPERTS.setdefault(type(jenv), jax.jit(jax.vmap(jenv.expert_action)))
    G = js.board.shape[0]
    acts = np.stack([np.asarray(expert(js, jax.random.split(jax.random.PRNGKey(k), G)))
                     for k in range(n_keys)])
    return np.where((acts == acts[0]).all(0), acts[0], -1)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_expert_matches_jax_on_random_positions(name):
    checked = 0
    gen = torch.Generator().manual_seed(0)
    for jenv, tenv, js, ts, _, _ in _random_games(name, 48, seed=2):
        want = _jax_expert_if_fixed(jenv, js)
        got = tenv.expert_action(ts, gen).numpy()
        fixed = (want >= 0) & ~ts.done.numpy()
        np.testing.assert_array_equal(got[fixed], want[fixed])
        legal = tenv.legal_actions_mask(ts).numpy()
        live = ~ts.done.numpy()
        assert legal[np.arange(len(got)), got][live].all()
        checked += int(fixed.sum())
    assert checked >= 40


def _tictactoe_after(moves):
    env = TicTacToe(device="cpu")
    s = env.reset(1)
    for a in moves:
        s, _, _ = env.step(s, torch.tensor([a]))
    return env, s


def _connect4_after(moves):
    env = Connect4(device="cpu")
    s = env.reset(1)
    for a in moves:
        s, _, _ = env.step(s, torch.tensor([a]))
    return env, s


@pytest.mark.parametrize("moves, want", [([0, 3, 1, 4], 2), ([0, 8, 1], 2)])
def test_tictactoe_expert_on_jax_test_positions(moves, want):
    env, s = _tictactoe_after(moves)
    assert int(env.expert_action(s, torch.Generator().manual_seed(0))[0]) == want


@pytest.mark.parametrize("moves, want", [([0, 1, 0, 1, 0, 2], 0), ([0, 0, 1, 1, 2], 3)])
def test_connect4_expert_on_jax_test_positions(moves, want):
    env, s = _connect4_after(moves)
    assert int(env.expert_action(s, torch.Generator().manual_seed(0))[0]) == want


def test_connect4_expert_respects_gravity_like_jax():
    """The JAX test's constructed board: player +1's row-1 threat at (1, 3) is
    not playable (column 3 is empty below it), player -1's bottom-row threat
    at (0, 3) is: both experts answer the same for every key."""
    board = np.zeros((6, 7), np.int8)
    board[0, :3] = -1
    board[1, :3] = 1
    jenv, tenv = JaxConnect4(), Connect4(device="cpu")
    js = Connect4State(board=jnp.asarray(board), player=jnp.int8(1), done=jnp.bool_(False))
    ts = BoardState(torch.from_numpy(board)[None], torch.tensor([1], dtype=torch.int8),
                    torch.tensor([False]))
    want = {int(jenv.expert_action(js, jax.random.PRNGKey(k))) for k in range(4)}
    assert want == {3}
    assert int(tenv.expert_action(ts, torch.Generator().manual_seed(1))[0]) == 3


def test_board_wins_and_rewards():
    env, s = _tictactoe_after([0, 3, 1, 4])
    s, r, d = env.step(s, torch.tensor([2]))
    assert float(r[0]) == 20.0 and bool(d[0])
    env, s = _connect4_after([3, 4, 3, 4, 3, 4])
    s, r, d = env.step(s, torch.tensor([3]))
    assert float(r[0]) == 10.0 and bool(d[0])
    s, r, d = env.step(s, torch.tensor([5]))  # a finished game pays nothing more
    assert float(r[0]) == 0.0 and bool(d[0])
    assert not env.legal_actions_mask(s).any()
