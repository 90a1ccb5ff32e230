"""The port's batched cartpole env and observation stacking against JAX.

Start states and actions are made with numpy from a seed and injected into
both; the JAX env runs vmapped over the same batch. Float32 physics through
sin/cos in two libraries agree to 1e-5 over 60 steps (a few ULP per step,
amplified by the unstable pole dynamics); done flags and rewards are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.envs.cartpole import CartPole as JaxCartPole
from muzero_general_tpu.envs.cartpole import CartPoleState as JaxState
from muzero_general_tpu.ops import stacking as jax_stacking
from muzero_general_tpu_torch.envs.cartpole import CartPole
from muzero_general_tpu_torch.envs.core import where_state
from muzero_general_tpu_torch.ops import stacking as torch_stacking


def test_cartpole_matches_jax_step_for_step():
    rng = np.random.default_rng(0)
    G, T = 64, 60
    start = rng.uniform(-0.2, 0.2, size=(G, 4)).astype(np.float32)
    start[:4, 2] = [0.2, -0.2, 0.205, -0.209]  # near the angle limit
    start[4:6, 0] = [2.39, -2.39]  # near the track edge
    actions = rng.integers(0, 2, size=(T, G)).astype(np.int32)

    jenv = JaxCartPole()
    jstate = JaxState(
        x=jnp.asarray(start[:, 0]), x_dot=jnp.asarray(start[:, 1]),
        theta=jnp.asarray(start[:, 2]), theta_dot=jnp.asarray(start[:, 3]),
        steps=jnp.zeros((G,), jnp.int32), done=jnp.zeros((G,), bool),
    )
    jstep = jax.jit(jax.vmap(jenv.step))
    jobs = jax.vmap(jenv.observation)
    keys = jax.random.split(jax.random.PRNGKey(0), G)

    env = CartPole(device="cpu")
    state = env.reset(G, start=torch.from_numpy(start))
    np.testing.assert_array_equal(env.observation(state).numpy(), np.asarray(jobs(jstate)))
    mixed = False  # a step where some games are done and some are not
    for t in range(T):
        jstate, jrew, jdone = jstep(jstate, jnp.asarray(actions[t]), keys)
        state, rew, done = env.step(state, torch.from_numpy(actions[t]).long())
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(state.steps.numpy(), np.asarray(jstate.steps))
        np.testing.assert_allclose(env.observation(state).numpy(),
                                   np.asarray(jobs(jstate)), atol=1e-5, rtol=0)
        mixed |= bool(done.any()) and not bool(done.all())
    assert mixed and done.all()  # done and live lanes, then stepping done states


def test_cartpole_reset_and_select():
    env = CartPole(device="cpu")
    gen = torch.Generator().manual_seed(0)
    a = env.reset(4096, gen)
    assert float(torch.stack(a[:4]).abs().max()) <= 0.05
    assert env.observation(a).shape == (4096, 1, 1, 4)
    assert env.legal_actions_mask(a).all() and env.legal_actions_mask(a).shape == (4096, 2)
    assert not env.to_play(a).any()
    b = env.reset(4096, torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(a, b))  # seeded
    with pytest.raises(ValueError):
        env.reset(3, start=torch.zeros(2, 4))
    c = env.reset(4096, gen)
    mask = torch.arange(4096) % 2 == 0
    mixed = where_state(mask, a, c)
    assert torch.equal(mixed.x[mask], a.x[mask]) and torch.equal(mixed.x[~mask], c.x[~mask])


@pytest.mark.parametrize("n", [0, 1, 3])
def test_stacking_matches_jax(n):
    rng = np.random.default_rng(n)
    G, A = 5, 3
    obs_hist = rng.normal(size=(G, n + 1, 2, 3, 4)).astype(np.float32)
    act_hist = rng.integers(0, A, size=(G, n + 1)).astype(np.int32)
    new_obs = rng.normal(size=(G, 2, 3, 4)).astype(np.float32)
    action = rng.integers(0, A, size=(G,)).astype(np.int32)
    obs0 = rng.normal(size=(G, 2, 3, 4)).astype(np.float32)
    done = np.array([True, False, True, False, False])

    t = lambda x: torch.from_numpy(x)  # noqa: E731
    np.testing.assert_array_equal(
        torch_stacking.stack_observations(t(obs_hist), t(act_hist), A).numpy(),
        np.asarray(jax_stacking.stack_observations(obs_hist, act_hist, A)),
    )
    got = torch_stacking.push_history(t(obs_hist), t(act_hist), t(new_obs), t(action))
    want = jax_stacking.push_history(obs_hist, act_hist, new_obs, action)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = torch_stacking.reset_history(*got, t(obs0), t(done))
    want = jax_stacking.reset_history(*want, obs0, done)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
