"""The port's FC network and checkpoint loading against the JAX package.

The same flax parameters (a random init, and the shipped cartpole
checkpoint) are carried into the port with params_from_jax; both networks
get the same numpy inputs. Outputs agree to atol 1e-5: float32 matmuls of
width <= 21 summed in different orders, then a min-max normalize that can
divide by a small range.
"""

import jax
import numpy as np
import pytest
import torch

from muzero_general_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from muzero_general_tpu.games.cartpole import MuZeroConfig as JaxConfig
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.ops import mcts_fused as jax_fused
from muzero_general_tpu_torch import checkpoint as torch_checkpoint
from muzero_general_tpu_torch.games.cartpole import MuZeroConfig
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from muzero_general_tpu_torch.ops import mcts_fused as torch_fused

ATOL = 1e-5
CHECKPOINT = "pretrained/cartpole/model.checkpoint"

VARIANTS = {
    "cartpole": {},
    "deeper": dict(encoding_size=6, fc_dynamics_layers=[16, 12],
                   fc_reward_layers=[], fc_value_layers=[8],
                   fc_policy_layers=[8], fc_representation_layers=[5]),
    "stacked": dict(stacked_observations=2, action_space=list(range(3))),
}


def _configs(overrides):
    jcfg, tcfg = JaxConfig(), MuZeroConfig()
    for cfg in (jcfg, tcfg):
        for key, value in overrides.items():
            setattr(cfg, key, value)
    return jcfg, tcfg


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _compare(jcfg, tcfg, variables, seed):
    runner = JaxNetwork(jcfg)
    net = MuZeroNetwork(tcfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    rng = np.random.default_rng(seed)
    B = 7
    obs = rng.normal(size=(B,) + runner.stacked_observation_shape()).astype(np.float32)
    actions = rng.integers(0, len(jcfg.action_space), size=(B,)).astype(np.int32)

    want = runner.initial_inference(variables, obs)
    with torch.no_grad():
        got = net.initial_inference(torch.from_numpy(obs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)

    hidden = np.array(want[3])
    want = runner.recurrent_inference(variables, hidden, actions)
    with torch.no_grad():
        got = net.recurrent_inference(torch.from_numpy(hidden),
                                      torch.from_numpy(actions))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    return net


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fc_matches_jax_random_init(variant):
    jcfg, tcfg = _configs(VARIANTS[variant])
    variables = _numpy_tree(JaxNetwork(jcfg).init(jax.random.PRNGKey(3)))
    _compare(jcfg, tcfg, variables, seed=11)


def test_fc_matches_jax_pretrained_cartpole():
    jcfg, tcfg = _configs({})
    variables = torch_checkpoint.load_checkpoint(CHECKPOINT)["weights"]
    net = _compare(jcfg, tcfg, variables, seed=12)
    # The fused search's weight list equals the JAX package's, array for array.
    want_flat, want_counts = jax_fused.extract_fc_weights(variables, jcfg.encoding_size)
    got_flat, got_counts = torch_fused.extract_fc_weights(net, tcfg.encoding_size)
    assert got_counts == want_counts
    for g, w in zip(got_flat, want_flat, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_params_from_jax_transposes_kernels():
    variables = torch_checkpoint.load_checkpoint(CHECKPOINT)["weights"]
    state = params_from_jax(variables)
    kernel = variables["params"]["dynamics_state_network"]["TorchDense_0"]["kernel"]
    assert kernel.shape == (10, 16)
    np.testing.assert_array_equal(
        state["dynamics_state_network.TorchDense_0.weight"].numpy(), kernel.T
    )
    net = MuZeroNetwork(MuZeroConfig(), device="cpu")
    assert set(state) == set(net.state_dict())


def test_load_checkpoint_matches_jax_without_optax():
    got = torch_checkpoint.load_checkpoint(CHECKPOINT)
    want = jax_load_checkpoint(CHECKPOINT)
    assert list(got) == torch_checkpoint.CHECKPOINT_KEYS == list(want)
    assert set(torch_checkpoint.initial_checkpoint()) == set(want)
    for key in torch_checkpoint.CHECKPOINT_KEYS:
        if key not in ("weights", "optimizer_state"):
            assert got[key] == want[key], key
    # optax state classes come back as tuple stand-ins with the same leaves
    assert all(
        isinstance(s, tuple) and type(s).__module__.startswith("optax")
        for s in got["optimizer_state"]
    )
    got_leaves = _leaves(got["optimizer_state"])
    want_leaves = jax.tree_util.tree_leaves(want["optimizer_state"])
    assert len(got_leaves) == len(want_leaves) > 0
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _leaves(tree):
    """Leaves of nested dicts (sorted keys, as jax) and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_network_init_is_seeded():
    a = MuZeroNetwork(MuZeroConfig(), device="cpu", seed=5).state_dict()
    b = MuZeroNetwork(MuZeroConfig(), device="cpu", seed=5).state_dict()
    c = MuZeroNetwork(MuZeroConfig(), device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    w = a["dynamics_state_network.TorchDense_0.weight"]
    assert float(w.abs().max()) <= 1 / np.sqrt(10)  # TorchDense U(+-1/sqrt(fan_in))
