"""The port's replay path (muzero_general_tpu_torch/replay.py, its C++ batch
assembler native/replay_sampler.cpp, ops/stacking.stack_observations_np,
prefetch.py) and its simple_grid game against the JAX package's.

Games are made with numpy from a seed; each side gets its own copies of
every array (JAX's side and the port's write priorities in place). Both
buffers draw from generators seeded alike, so every comparison is exact:
targets, priorities and batches bit for bit (the port's native path too),
the env step for step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu import replay as jax_replay
from muzero_general_tpu.config import MuZeroConfig as JaxBaseConfig
from muzero_general_tpu.envs.simple_grid import SimpleGrid as JaxSimpleGrid
from muzero_general_tpu.envs.simple_grid import SimpleGridState as JaxGridState
from muzero_general_tpu.games.simple_grid import MuZeroConfig as JaxGridConfig
from muzero_general_tpu.ops.stacking import stack_observations_np as jax_stack_np
from muzero_general_tpu_torch import replay
from muzero_general_tpu_torch.config import MuZeroConfig as BaseConfig
from muzero_general_tpu_torch.envs.simple_grid import SimpleGrid
from muzero_general_tpu_torch.games import AVAILABLE_GAMES
from muzero_general_tpu_torch.games.simple_grid import MuZeroConfig as GridConfig
from muzero_general_tpu_torch.native import build
from muzero_general_tpu_torch.ops.stacking import stack_observations_np
from muzero_general_tpu_torch.prefetch import BatchPrefetcher

def _games(n, A=3, obs=(2, 3, 3), players=1, L=14, seed=0, zero_rewards=False):
    """n games of lengths L, L+1, ... as dicts of numpy arrays."""
    rng = np.random.default_rng(seed)
    games = []
    for s in range(n):
        Ls = L + s
        rewards = np.concatenate([[0], rng.normal(size=Ls)]).astype(np.float32)
        if zero_rewards:
            rewards[1::2] = 0.0
        games.append({
            "observations": rng.normal(size=(Ls, *obs)).astype(np.float32),
            "actions": np.concatenate([[0], rng.integers(0, A, Ls)]).astype(np.int32),
            "rewards": rewards,
            "to_play": (np.arange(Ls + 1) % players).astype(np.int32),
            "child_visits": rng.dirichlet(np.ones(A), Ls).astype(np.float32),
            "root_values": rng.normal(size=Ls).astype(np.float32),
        })
    return games


def _pair(game, reanalysed=None):
    """The same game as a JAX GameHistory and a port one, each on copies."""
    extra = {} if reanalysed is None else {"reanalysed_predicted_root_values": reanalysed}
    return (jax_replay.GameHistory(**{k: v.copy() for k, v in game.items()},
                                   **{k: v.copy() for k, v in extra.items()}),
            replay.GameHistory(**{k: v.copy() for k, v in game.items()},
                               **{k: v.copy() for k, v in extra.items()}))


def _configs(players=1, stacked=0, td_steps=5, discount=0.97, A=3, obs=(2, 3, 3),
             batch_size=32, unroll=6, buffer_size=3000):
    cfgs = (JaxBaseConfig(), BaseConfig())
    for cfg in cfgs:
        cfg.observation_shape = obs
        cfg.action_space = list(range(A))
        cfg.players = list(range(players))
        cfg.stacked_observations = stacked
        cfg.batch_size = batch_size
        cfg.num_unroll_steps = unroll
        cfg.td_steps = td_steps
        cfg.discount = discount
        cfg.replay_buffer_size = buffer_size
    return cfgs


def _buffers(cfgs, games, reanalysed=False):
    jbuf, tbuf = jax_replay.ReplayBuffer(cfgs[0]), replay.ReplayBuffer(cfgs[1])
    for g in games:
        rv = g["root_values"] * 3 if reanalysed else None
        jgh, tgh = _pair(g, rv)
        jbuf.save_game(jgh)
        tbuf.save_game(tgh)
    return jbuf, tbuf


def _assert_bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=what)


def _assert_buffers_equal(jbuf, tbuf):
    assert list(jbuf.buffer) == list(tbuf.buffer)
    assert jbuf.total_samples == tbuf.total_samples
    assert jbuf.num_played_steps == tbuf.num_played_steps
    for gid, jgh in jbuf.buffer.items():
        tgh = tbuf.buffer[gid]
        _assert_bits(tgh.priorities, jgh.priorities, f"priorities of game {gid}")
        assert tgh.game_priority == jgh.game_priority


# ---- targets --------------------------------------------------------------


@pytest.mark.parametrize("players", [1, 2])
@pytest.mark.parametrize("td_steps", [3, 10, 100])
@pytest.mark.parametrize("discount", [0.97, 1])
@pytest.mark.parametrize("reanalysed", [False, True])
def test_compute_target_values_matches_jax(players, td_steps, discount, reanalysed):
    game = _games(1, players=players, L=17, seed=td_steps, zero_rewards=True)[0]
    rv = game["root_values"][::-1] * 2 if reanalysed else None
    jgh, tgh = _pair(game, rv)
    idx = np.arange(17 + 4)  # past the game's end: the absorbing positions
    _assert_bits(replay.compute_target_values(tgh, idx, td_steps, discount),
                 jax_replay.compute_target_values(jgh, idx, td_steps, discount), "values")


@pytest.mark.parametrize("players", [1, 2])
@pytest.mark.parametrize("pos", [0, 5, 11, 12, 13])  # L = 14: boundary and absorbing at the end
def test_make_target_matches_jax(players, pos):
    game = _games(1, players=players, seed=pos)[0]
    jgh, tgh = _pair(game)
    want = jax_replay.make_target(jgh, pos, 6, 4, 0.997, 3, np.random.default_rng(pos))
    got = replay.make_target(tgh, pos, 6, 4, 0.997, 3, np.random.default_rng(pos))
    for name, g, w in zip(("values", "rewards", "policies", "actions"), got, want):
        _assert_bits(g, w, name)


def test_stack_observations_np_matches_jax():
    game = _games(1, A=4, obs=(3, 2, 2), seed=3)[0]
    for n in (0, 1, 3):
        for index in (0, 1, 2, 9):
            _assert_bits(stack_observations_np(game["observations"], game["actions"], index, n, 4),
                         jax_stack_np(game["observations"], game["actions"], index, n, 4),
                         f"n={n} index={index}")


# ---- the buffer -----------------------------------------------------------


@pytest.mark.parametrize("players", [1, 2])
@pytest.mark.parametrize("stacked", [0, 2])
def test_get_batch_native_and_numpy_match_jax_bit_for_bit(players, stacked):
    jcfg, tcfg = _configs(players=players, stacked=stacked, td_steps=10, discount=0.997)
    jbuf, tbuf = _buffers((jcfg, tcfg), _games(6, players=players, seed=players + stacked))
    _assert_buffers_equal(jbuf, tbuf)
    for seed in (42, 43):
        jbuf.rng = np.random.default_rng(seed)
        want_idx, want = jbuf.get_batch(use_native=False)
        for use_native in (True, False):
            tbuf.rng = np.random.default_rng(seed)
            idx, batch = tbuf.get_batch(use_native=use_native)
            _assert_bits(idx, want_idx, "index_batch")
            assert sorted(batch) == sorted(want)
            for key in want:
                _assert_bits(batch[key], want[key], f"{key} (native={use_native})")
            # The PER weights: in (0, 1], the largest 1.
            assert (batch["weight"] > 0).all() and batch["weight"].max() == 1.0
        # Absorbing positions were drawn (random actions past the end).
        lengths = np.array([len(tbuf.buffer[int(g)]) for g in want_idx[:, 0]])
        assert (want_idx[:, 1][:, None] + np.arange(7) > lengths[:, None]).any()


@pytest.mark.parametrize("td_steps, discount, reanalysed", [(3, 1, True), (50, 0.997, False),
                                                            (200, 0.99, True)])
def test_get_batch_matches_jax_at_td_steps(td_steps, discount, reanalysed):
    """Long td_steps sum the rewards in numpy's pairwise blocks (8 and 128)."""
    jcfg, tcfg = _configs(players=2, td_steps=td_steps, discount=discount, unroll=5)
    jbuf, tbuf = _buffers((jcfg, tcfg), _games(4, players=2, L=60, seed=td_steps), reanalysed)
    jbuf.rng = np.random.default_rng(7)
    want_idx, want = jbuf.get_batch(use_native=False)
    for use_native in (True, False):
        tbuf.rng = np.random.default_rng(7)
        idx, batch = tbuf.get_batch(use_native=use_native)
        _assert_bits(idx, want_idx, "index_batch")
        for key in want:
            _assert_bits(batch[key], want[key], f"{key} (native={use_native})")


def test_priorities_after_save_and_update_match_jax():
    """save_game's initial priorities, then update_priorities with a batch
    that names evicted games (the stale-id guard) and runs past a game's end."""
    jcfg, tcfg = _configs(players=2, td_steps=4, buffer_size=4)
    jbuf, tbuf = _buffers((jcfg, tcfg), _games(6, players=2, seed=5))
    _assert_buffers_equal(jbuf, tbuf)
    assert list(tbuf.buffer) == [2, 3, 4, 5]  # games 0 and 1 evicted
    rng = np.random.default_rng(9)
    index_batch = np.array([[0, 3], [2, 1], [3, 12], [5, 16], [1, 0], [4, 0]], np.int64)
    priorities = rng.uniform(0, 2, (6, 7)).astype(np.float32)
    jbuf.update_priorities(priorities.copy(), index_batch.copy())
    tbuf.update_priorities(priorities.copy(), index_batch.copy())
    _assert_buffers_equal(jbuf, tbuf)
    np.testing.assert_array_equal(tbuf.buffer[5].priorities[16:], priorities[3, :3])
    # Batches sampled from the updated priorities agree too.
    jbuf.rng, tbuf.rng = np.random.default_rng(1), np.random.default_rng(1)
    want_idx, want = jbuf.get_batch(use_native=False)
    idx, batch = tbuf.get_batch()
    _assert_bits(idx, want_idx, "index_batch")
    _assert_bits(batch["weight"], want["weight"], "weight")


def test_uniform_sampling_matches_jax():
    jcfg, tcfg = _configs()
    jcfg.PER = tcfg.PER = False
    jbuf, tbuf = _buffers((jcfg, tcfg), _games(5, seed=2))
    jbuf.rng, tbuf.rng = np.random.default_rng(3), np.random.default_rng(3)
    want_idx, want = jbuf.get_batch(use_native=False)
    idx, batch = tbuf.get_batch()
    _assert_bits(idx, want_idx, "index_batch")
    for key in want:
        _assert_bits(batch[key], want[key], key)
    assert (batch["weight"] == 1).all()


def test_reanalyse_pick_round_robin_and_observations_match_jax():
    jcfg, tcfg = _configs(stacked=2, buffer_size=5)
    jbuf, tbuf = _buffers((jcfg, tcfg), _games(4, seed=4))
    picks = []
    for n in (3, 3, 2, 9):
        want = [gid for gid, _ in jbuf.reanalyse_pick(n)]
        got = [gid for gid, _ in tbuf.reanalyse_pick(n)]
        assert got == want
        picks.append(got)
        if n == 3:  # a game lands mid-cycle: the second evicts game 0
            g = _games(1, seed=10 + len(picks))[0]
            jgh, tgh = _pair(g)
            jbuf.save_game(jgh)
            tbuf.save_game(tgh)
    assert list(tbuf.buffer) == [1, 2, 3, 4, 5]
    # The cursor wraps to the oldest game, then skips the evicted game 0.
    assert picks == [[0, 1, 2], [3, 4, 0], [1, 2], [3, 4, 5, 1, 2]]
    for gid in tbuf.buffer:
        _assert_bits(tbuf.reanalyse_observations(tbuf.buffer[gid]),
                     jbuf.reanalyse_observations(jbuf.buffer[gid]), f"game {gid}")
    values = np.linspace(-1, 1, len(tbuf.buffer[3])).astype(np.float64)
    for buf in (jbuf, tbuf):
        buf.update_reanalysed_values(3, values.copy())
        buf.update_reanalysed_values(0, values.copy())  # evicted: ignored
    _assert_bits(tbuf.buffer[3].reanalysed_predicted_root_values,
                 jbuf.buffer[3].reanalysed_predicted_root_values, "reanalysed values")
    assert all(tbuf.buffer[g].reanalysed_predicted_root_values is None for g in (1, 2, 4, 5))


def test_assembler_build_failure_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    broken = tmp_path / "replay_sampler.cpp"
    broken.write_text("#include <Python.h>\nthis is not C++;\n")
    _, tcfg = _configs()
    tbuf = replay.ReplayBuffer(tcfg)
    for g in _games(2):
        tbuf.save_game(_pair(g)[1])
    monkeypatch.setattr(build, "REPLAY_SRC", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tbuf.get_batch()
    assert not build.replay_native_path().exists()
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tbuf.get_batch(use_native=True)
    idx, batch = tbuf.get_batch(use_native=False)  # the numpy path, asked for
    assert batch["observation"].shape == (32, 2, 3, 3)


def test_assembler_rejects_arrays_it_cannot_read():
    native = build.load_replay_native()
    _, tcfg = _configs()
    tbuf = replay.ReplayBuffer(tcfg)
    for g in _games(2):
        tbuf.save_game(_pair(g)[1])
    tbuf.buffer[0].actions = tbuf.buffer[0].actions.astype(np.int64)  # get_batch casts it
    tbuf.get_batch()
    out = np.zeros((1, 2, 3, 3), np.float32)
    args = lambda actions, pos: (  # noqa: E731
        [np.zeros((3, 2, 3, 3), np.float32)], [actions], [np.zeros(4, np.float32)],
        [np.zeros(4, np.int32)], [np.zeros((3, 3), np.float32)], [np.zeros(3, np.float32)],
        np.array([pos], np.int32), np.zeros((1, 2), np.int32), 1, 2, 0.9,
        np.array([1.0, 0.9]), 3, 0, 2, 3, 3, out, np.zeros((1, 2), np.int32),
        np.zeros((1, 2), np.float32), np.zeros((1, 2), np.float32),
        np.zeros((1, 2, 3), np.float32), np.zeros((1, 2), np.float32))
    native.assemble_batch(*args(np.zeros(4, np.int32), 2))
    with pytest.raises(TypeError, match="int32"):
        native.assemble_batch(*args(np.zeros(4, np.int64), 2))
    with pytest.raises(IndexError):
        native.assemble_batch(*args(np.zeros(4, np.int32), 3))


# Each game array cut to a size its game's length does not give it.
_WRONG_SIZE = {
    "observations": lambda gh: gh.observations[..., :-1].copy(),  # [L, C, H, W - 1]
    "actions": lambda gh: gh.actions[:-1].copy(),
    "rewards": lambda gh: gh.rewards[:-1].copy(),
    "to_play": lambda gh: gh.to_play[:-1].copy(),
    "child_visits": lambda gh: gh.child_visits[:, :-1].copy(),  # [L, A - 1]
    "reanalysed": lambda gh: gh.root_values[:-1].copy(),
}


@pytest.mark.parametrize("field", list(_WRONG_SIZE))
def test_assembler_rejects_a_game_array_of_the_wrong_size(field):
    """The assembler checks every game array's size against the game's
    length before it fills the batch without bounds checks: a reanalysed
    value array one short (stored through update_reanalysed_values) raises
    ValueError, as does any other array of the wrong size."""
    _, tcfg = _configs(batch_size=8)
    tbuf = replay.ReplayBuffer(tcfg)
    for g in _games(2):
        tbuf.save_game(_pair(g)[1])
    tbuf.get_batch(use_native=True)
    for gid, gh in tbuf.buffer.items():
        if field == "reanalysed":
            tbuf.update_reanalysed_values(gid, _WRONG_SIZE[field](gh))
        else:
            setattr(gh, field, _WRONG_SIZE[field](gh))
    name = "root_values" if field == "reanalysed" else field
    with pytest.raises(ValueError, match=f"game \\d+: {name} .* holds"):
        tbuf.get_batch(use_native=True)


def test_prefetcher_takes_the_batches_get_batch_gives_and_raises_its_failures():
    _, tcfg = _configs(batch_size=8)
    bufs = [replay.ReplayBuffer(tcfg) for _ in range(2)]
    for g in _games(3, seed=6):
        for buf in bufs:
            buf.save_game(_pair(g)[1])
    want = [bufs[0].get_batch() for _ in range(3)]
    prefetcher = BatchPrefetcher(bufs[1], depth=2)
    try:
        got = prefetcher.take(3)
    finally:
        prefetcher.stop()
    assert not prefetcher._thread.is_alive()
    for (gi, gb), (wi, wb) in zip(got, want):
        _assert_bits(gi, wi, "index_batch")
        for key in wb:
            _assert_bits(gb[key], wb[key], key)

    class Failing:
        buffer = {0: None}

        def get_batch(self):
            raise ValueError("no batch")

    prefetcher = BatchPrefetcher(Failing())
    try:
        with pytest.raises(RuntimeError, match="producer failed") as info:
            prefetcher.take(1)
        assert isinstance(info.value.__cause__, ValueError)
    finally:
        prefetcher.stop()


# ---- simple_grid -----------------------------------------------------------


def test_simple_grid_config_matches_jax_attribute_for_attribute():
    want, got = vars(JaxGridConfig()), vars(GridConfig())
    assert set(want) <= set(got)  # the port's base config holds every knob
    for key, value in want.items():
        assert got[key] == value, key
    for trained in (0, 10_000, 29_999):
        assert GridConfig().visit_softmax_temperature_fn(trained) == 1
    assert "simple_grid" in AVAILABLE_GAMES


def test_simple_grid_matches_jax_step_for_step():
    """Random Down/Right walks: border no-ops, arrival, then stepping done
    states; observations, masks, rewards and done flags equal every step."""
    G, T = 48, 8
    actions = np.random.default_rng(0).integers(0, 2, (T, G)).astype(np.int32)
    jenv, tenv = JaxSimpleGrid(), SimpleGrid(device="cpu")
    jstate = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), G))
    jstep = jax.vmap(jenv.step, in_axes=(0, 0, None))
    tstate = tenv.reset(G)
    key = jax.random.PRNGKey(1)

    def check(js, ts):
        np.testing.assert_array_equal(ts.row.numpy(), np.asarray(js.row))
        np.testing.assert_array_equal(ts.col.numpy(), np.asarray(js.col))
        np.testing.assert_array_equal(tenv.observation(ts).numpy(),
                                      np.asarray(jax.vmap(jenv.observation)(js)))
        np.testing.assert_array_equal(tenv.legal_actions_mask(ts).numpy(),
                                      np.asarray(jax.vmap(jenv.legal_actions_mask)(js)))
        np.testing.assert_array_equal(tenv.to_play(ts).numpy(), np.zeros(G, np.int32))

    check(jstate, tstate)
    arrived = 0
    for t in range(T):
        jstate, jrew, jdone = jstep(jstate, jnp.asarray(actions[t]), key)
        tstate, rew, done = tenv.step(tstate, torch.from_numpy(actions[t]))
        check(jstate, tstate)
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        arrived += int((rew == 10).sum())
    # Walks that arrived were stepped on as done states; the others are live.
    assert 0 < arrived == int(done.sum()) < G
    # A state at the goal's row steps Down as a no-op.
    edge = JaxGridState(jnp.int32(2), jnp.int32(0), jnp.bool_(False))
    js, jr, jd = jenv.step(edge, jnp.int32(0), key)
    ts, tr, td = tenv.step(tenv.reset(1)._replace(row=torch.tensor([2], dtype=torch.int32)),
                           torch.tensor([0]))
    assert int(ts.row[0]) == int(js.row) == 2 and float(tr[0]) == float(jr) == 0.0
