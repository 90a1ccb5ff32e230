"""The port's twentyone, gridworld and breakout envs and game modules against
the JAX package's.

Each env runs a batch of games step for step beside the JAX env, vmapped,
from the same start and the same random actions, through done states. The
JAX env's draws (cards, start cells, serve choices) are read here by
repeating its own key splits and handed to the port as injected draws.
Observations, rewards, done flags and every state field must then be
exact: the envs are integer logic and float32 operations in the JAX
source's order. The JAX envs run op by op (vmap, no jit): under jit XLA
folds gridworld's 0.9 * steps / 144 into steps * (0.9 / 144) and fuses it
into the subtraction, which moves the reward by an ulp; op by op is the
source's arithmetic.
"""

import builtins
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.config import load_game_module as jax_game
from muzero_general_tpu.envs import breakout_jax as jax_breakout
from muzero_general_tpu.envs import gridworld as jax_gridworld
from muzero_general_tpu.envs import twentyone as jax_twentyone
from muzero_general_tpu.games import AVAILABLE_GAMES as JAX_GAMES
from muzero_general_tpu_torch.config import load_game_module
from muzero_general_tpu_torch.envs import breakout, gridworld, twentyone
from muzero_general_tpu_torch.envs.core import where_state
from muzero_general_tpu_torch.games import AVAILABLE_GAMES

GAMES = ["twentyone", "gridworld", "breakout"]


def assert_same_state(state, jstate, what=""):
    """Every field of the port's state equals JAX's of that name."""
    for name, got in zip(state._fields, state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jstate, name)),
                                      err_msg=f"{what} {name}")


def step_both(env, jenv, state, jstate, actions, keys=None, **draws):
    """One step on each side; the outputs must be equal. Returns the states."""
    jstate, jreward, jdone = jax.vmap(jenv.step)(jstate, jnp.asarray(actions), keys)
    state, reward, done = env.step(state, torch.from_numpy(actions), **draws)
    assert reward.dtype == torch.float32 and done.dtype == torch.bool
    np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert_same_state(state, jstate)
    np.testing.assert_array_equal(env.observation(state).numpy(),
                                  np.asarray(jax.vmap(jenv.observation)(jstate)))
    return state, jstate


# ---------------------------------------------------------------------------
# twentyone
# ---------------------------------------------------------------------------


def _twentyone_reset_draws(key):
    k1, k2 = jax.random.split(key)
    return jnp.stack([jax_twentyone._card(k1), jax_twentyone._card(k2)])


def _twentyone_step_draws(key):
    """JAX TwentyOne.step's cards: the hit card, then the dealer's loop's
    successive splits (twentyone.py:47-66)."""
    k_hit, k = jax.random.split(key)
    cards = [jax_twentyone._card(k_hit)]
    for _ in range(twentyone.DEALER_DRAWS):
        k, sub = jax.random.split(k)
        cards.append(jax_twentyone._card(sub))
    return jnp.stack(cards)


def test_twentyone_matches_jax_step_for_step():
    G, T = 64, 8
    rng = np.random.default_rng(0)
    env, jenv = twentyone.TwentyOne(device="cpu"), jax_twentyone.TwentyOne()
    keys = jax.random.split(jax.random.PRNGKey(0), G)
    jstate = jax.vmap(jenv.reset)(keys)
    start = np.array(jax.vmap(_twentyone_reset_draws)(keys))
    state = env.reset(G, start=torch.from_numpy(start))
    assert_same_state(state, jstate, "reset")
    stepped_done = False
    for t in range(T):
        keys = jax.random.split(jax.random.PRNGKey(t + 1), G)
        actions = (rng.random(G) < 0.3).astype(np.int32)  # mostly hits
        cards = np.array(jax.vmap(_twentyone_step_draws)(keys))
        stepped_done |= bool(state.done.any())
        state, jstate = step_both(env, jenv, state, jstate, actions, keys,
                                  cards=torch.from_numpy(cards))
    assert stepped_done and bool(state.done.all())
    # Busts, wins, pushes and losses all occurred along the way.
    player = state.player_hand.numpy()
    assert (player > 21).any() and (player == 21).any() and (player < 21).any()


def test_twentyone_draws_and_checks():
    env = twentyone.TwentyOne(device="cpu")
    state = env.reset(4096, torch.Generator().manual_seed(0))
    for hand in (state.player_hand, state.dealer_hand):
        assert hand.dtype == torch.int32 and set(hand.unique().tolist()) == set(range(1, 11))
    # randint(1, 13) is 1..12, and 10, 11 and 12 count 10: three times as
    # likely as another value.
    assert float((state.player_hand == 10).float().mean()) == pytest.approx(3 / 12, abs=0.03)
    again = env.reset(4096, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(state, again))
    stood, reward, done = env.step(state, torch.ones(4096, dtype=torch.long),
                                   torch.Generator().manual_seed(1))
    assert done.all() and bool((stood.dealer_hand > 16).all())
    # A one-card hand cannot tie a dealer above 16: wins (dealer bust) and losses.
    assert set(reward.unique().tolist()) == {-10.0, 10.0}
    with pytest.raises(ValueError):
        env.step(state, torch.zeros(4096), cards=torch.ones(4096, 3))
    with pytest.raises(ValueError):
        env.reset(2, start=torch.ones(3, 2))


# ---------------------------------------------------------------------------
# gridworld
# ---------------------------------------------------------------------------


def test_gridworld_matches_jax_step_for_step():
    G, T = 48, 30
    rng = np.random.default_rng(1)
    env, jenv = gridworld.GridWorld(device="cpu"), jax_gridworld.GridWorld()
    keys = jax.random.split(jax.random.PRNGKey(5), G)
    jstate = jax.vmap(jenv.reset)(keys)
    start = np.stack([np.asarray(jstate.x), np.asarray(jstate.y), np.asarray(jstate.dir)], 1)
    state = env.reset(G, start=torch.from_numpy(start))
    assert_same_state(state, jstate, "reset")
    np.testing.assert_array_equal(env.observation(state).numpy(),
                                  np.asarray(jax.vmap(jenv.observation)(jstate)))
    rewarded = 0
    for _ in range(T):
        actions = rng.choice(3, G, p=[0.2, 0.2, 0.6]).astype(np.int32)
        state, jstate = step_both(env, jenv, state, jstate, actions, keys)
        rewarded += int((state.done & (state.x == gridworld.GOAL[0])).sum())
    # Goals reached, done states stepped on, some games still running.
    assert rewarded and state.done.any() and not state.done.all()


def test_gridworld_truncates_at_max_steps_and_rewards_by_steps():
    env, jenv = gridworld.GridWorld(device="cpu"), jax_gridworld.GridWorld()
    # (x, y, dir, steps): facing the goal from (3, 4) after 0, 100 and 142
    # steps; a lane at (1, 1) facing a wall at step 143 (truncated).
    cols = np.array([[3, 4, 0, 0], [3, 4, 0, 100], [3, 4, 0, 142], [1, 1, 2, 143]], np.int32)
    jstate = jax_gridworld.GridWorldState(*(jnp.asarray(c) for c in cols.T),
                                          jnp.zeros(4, bool))
    state = gridworld.GridWorldState(*(torch.from_numpy(c.copy()) for c in cols.T),
                                     torch.zeros(4, dtype=torch.bool))
    state, jstate = step_both(env, jenv, state, jstate, np.full(4, 2, np.int32))
    assert state.done.all() and float(state.x[3]) == 1  # the wall blocks
    # Stepping done states: rewards 0, steps on, still done.
    step_both(env, jenv, state, jstate, np.array([0, 1, 2, 2], np.int32))


def test_gridworld_reset_draws_inner_cells_but_the_goal():
    env = gridworld.GridWorld(device="cpu")
    state = env.reset(4096, torch.Generator().manual_seed(0))
    cells = set(zip(state.x.tolist(), state.y.tolist()))
    assert cells == {(x, y) for x in range(1, 5) for y in range(1, 5)} - {gridworld.GOAL}
    assert set(state.dir.tolist()) == {0, 1, 2, 3}
    assert not state.done.any() and not state.steps.any()
    assert env.observation(state).shape == (4096, 7, 7, 3)


# ---------------------------------------------------------------------------
# breakout
# ---------------------------------------------------------------------------

_SERVE_VX = np.array(breakout.SERVE_VX, np.float32)


def _jax_serve_choice(key):
    """The serve speed JAX's step draws from the state's key (breakout_jax.py
    :106-108, :117-119)."""
    k_serve, _ = jax.random.split(jax.random.fold_in(key, 1))
    return jax.random.choice(k_serve, jnp.asarray(_SERVE_VX))


_serve_choices = jax.jit(jax.vmap(_jax_serve_choice))  # key arithmetic: exact under jit


def _serve_indices(jstate):
    vx = np.asarray(_serve_choices(jstate.key))
    return torch.from_numpy(np.argmax(vx[:, None] == _SERVE_VX[None], axis=1))


def test_breakout_matches_jax_step_for_step():
    G, T = 16, 260
    rng = np.random.default_rng(2)
    env, jenv = breakout.Breakout(device="cpu"), jax_breakout.BreakoutJax()
    keys = jax.random.split(jax.random.PRNGKey(9), G)
    jstate = jax.vmap(jenv.reset)(keys)
    state = env.reset(G)
    assert_same_state(state, jstate, "reset")  # every field but JAX's key
    jstep = jax.vmap(jenv.step)
    hits = bounces = 0
    for t in range(T):
        actions = rng.choice(4, G, p=[0.2, 0.3, 0.25, 0.25]).astype(np.int32)
        serve = _serve_indices(jstate)
        jstate, jreward, jdone = jstep(jstate, jnp.asarray(actions), keys)
        vy_before = state.vel_y
        state, reward, done = env.step(state, torch.from_numpy(actions), serve=serve)
        np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        assert_same_state(state, jstate, f"step {t}")
        if t % 40 == 0 or t == T - 1:
            np.testing.assert_array_equal(env.observation(state).numpy(),
                                          np.asarray(jax.vmap(jenv.observation)(jstate)))
        hits += int((reward > 0).sum())
        bounces += int(((vy_before > 0) & (state.vel_y < 0) & (state.ball_y > 80)).sum())
    assert hits >= 10 and bounces >= 1  # bricks broken, paddle bounces


def _breakout_states(**fields):
    """The same hand-made state on both sides (defaults: a fresh game)."""
    env = breakout.Breakout(device="cpu")
    state = env.reset(len(next(iter(fields.values()))))._replace(
        **{k: torch.as_tensor(v) for k, v in fields.items()})
    jstate = jax_breakout.BreakoutState(
        *(jnp.asarray(x.numpy()) for x in state),
        key=jax.random.split(jax.random.PRNGKey(0), state.paddle_x.shape[0]))
    return env, state, jstate


def test_breakout_truncates_rows_toward_zero_and_ends():
    """A live ball moving up to y = 22.5 (above the brick band): JAX's
    astype(int32) truncates (22.5 - 24) / 3 = -0.5 to row 0 and hits the
    row-0 brick; a floor would give row -1 and no hit. Lane 1 loses its
    last ball (done), lane 2 clears the last brick (done), lane 3 is done
    already (reward 0)."""
    bricks = np.ones((4, 6, 16), bool)
    bricks[2] = False
    bricks[2, 5, 8] = True  # the last brick, under lane 2's ball
    env, state, jstate = _breakout_states(
        ball_x=np.array([30.0, 50.0, 50.0, 30.0], np.float32),
        ball_y=np.array([24.0, 95.0, 40.0, 24.0], np.float32),
        vel_x=np.zeros(4, np.float32),
        vel_y=np.array([-1.5, 1.5, 1.5, -1.5], np.float32),
        ball_live=np.ones(4, bool),
        bricks=bricks,
        lives=np.array([5, 1, 5, 5], np.int32),
        done=np.array([False, False, False, True]))
    state, jstate = step_both(env, jax_breakout.BreakoutJax(), state, jstate,
                              np.zeros(4, np.int32), jstate.key, serve=torch.zeros(4))
    assert float(state.ball_y[0]) == 22.5 and not bool(state.bricks[0, 0, 5])
    assert state.done[1:].all() and not state.done[0]


def test_breakout_draws_serves_from_the_generator():
    env = breakout.Breakout(device="cpu")
    state = env.reset(4096)
    fire = torch.ones(4096, dtype=torch.long)
    a, _, _ = env.step(state, fire, torch.Generator().manual_seed(3))
    b, _, _ = env.step(state, fire, torch.Generator().manual_seed(3))
    assert torch.equal(a.vel_x, b.vel_x) and bool(a.ball_live.all())
    assert set(a.vel_x.tolist()) == set(breakout.SERVE_VX)
    obs = env.observation(a)
    assert obs.shape == (4096, 3, 96, 96) and obs.dtype == torch.float32
    assert 0.0 <= float(obs.min()) and float(obs.max()) == 1.0
    mixed = where_state(torch.arange(4096) % 2 == 0, a, state)
    assert bool(mixed.ball_live[0]) and not bool(mixed.ball_live[1])


# ---------------------------------------------------------------------------
# Game modules, human-facing helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("game", GAMES)
def test_configs_match_jax_attribute_for_attribute(game):
    cfg, jcfg = load_game_module(game).MuZeroConfig(), jax_game(game).MuZeroConfig()
    assert vars(cfg) == vars(jcfg)
    for step in (0, 1, 0.5 * cfg.training_steps, 0.8 * cfg.training_steps, 500e3, 800e3):
        assert cfg.visit_softmax_temperature_fn(step) == jcfg.visit_softmax_temperature_fn(step)
    assert game in AVAILABLE_GAMES


def test_available_games_follow_the_jax_list():
    """JAX's list, in its order: the host-env games (lunarlander, atari,
    spiel) too."""
    assert AVAILABLE_GAMES == JAX_GAMES


def _one_game_states(game):
    env, jenv = load_game_module(game).make_env(device="cpu"), jax_game(game).make_env()
    key = jax.random.PRNGKey(7)
    jstate = jenv.reset(key)
    if game == "twentyone":
        start = np.array(_twentyone_reset_draws(key))[None]
    elif game == "gridworld":
        start = np.array([[int(jstate.x), int(jstate.y), int(jstate.dir)]])
    else:
        start = None
    state = env.reset(1, start=None if start is None else torch.from_numpy(start))
    return env, state, jenv, jstate


@pytest.mark.parametrize("game", GAMES)
def test_render_and_action_to_string_match_jax(game, capsys, monkeypatch):
    env, state, jenv, jstate = _one_game_states(game)
    strings = [env.action_to_string(a) for a in range(env.num_actions)]
    assert strings == [jenv.action_to_string(a) for a in range(jenv.num_actions)]
    assert strings == [env.action_to_string(np.int64(a)) for a in range(env.num_actions)]
    jenv.render(jstate)
    want = capsys.readouterr().out
    env.render(state)
    assert capsys.readouterr().out == want
    feed = iter(["x", "9", "1"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(feed))
    assert env.human_to_action(state) == 1


def test_breakout_make_env_refuses_where_jax_would_play_ale(monkeypatch):
    """Without ale-py the on-device Breakout; where ale-py imports, ALE
    Breakout on the host (envs/host.py AtariBreakout), as the JAX package's
    make_env does. ale-py is absent here: a stand-in module takes its place,
    and gymnasium.make hands out the fake ALE backend of test_misc_envs.py."""
    import sys
    import types

    import gymnasium

    from muzero_general_tpu_torch.envs import host
    from test_misc_envs import _FakeALE

    module = load_game_module("breakout")
    assert importlib.util.find_spec("ale_py") is None
    assert isinstance(module.make_env(device="cpu"), breakout.Breakout)
    monkeypatch.setitem(sys.modules, "ale_py", types.ModuleType("ale_py"))
    made = []
    monkeypatch.setattr(gymnasium, "make", lambda name, **kw: made.append(name) or _FakeALE())
    env = module.make_env(seed=1, device="cpu")
    assert isinstance(env, host.AtariBreakout) and env.host_env and made == ["ALE/Breakout-v5"]
    assert env.reset().shape == (3, 96, 96)
