"""The port's batch norm in train mode against flax's nn.BatchNorm.

flax `nn.BatchNorm(use_running_average=not train, momentum=0.9)` (JAX
models/common.py ResidualBlock, models/resnet.py) normalises a training
batch by the batch's biased statistics and updates its running statistics
as ra = 0.9 * ra + 0.1 * batch, the variance biased too; the learner trains
through it (trainer.py apply_train, mutable=["batch_stats"]). The same flax
variables, with randomized batch-norm parameters and running statistics, go
into the port through params_from_jax, and the same numpy inputs through
one train-mode forward of each side. Outputs agree to OUT_ATOL = 1e-5
(float32 convolutions summed in another order), the updated running
statistics to STATS_RTOL = 1e-6 relative (one batch mean and variance of
float32 values, then one blend with the old statistics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.games.tictactoe import MuZeroConfig as JaxTicTacToe
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.models.common import ResidualBlock as JaxResidualBlock
from muzero_general_tpu_torch.games.tictactoe import MuZeroConfig as TicTacToe
from muzero_general_tpu_torch.models import MuZeroNetwork, params_from_jax
from muzero_general_tpu_torch.models.common import ResidualBlock

OUT_ATOL = 1e-5  # see the module docstring
STATS_RTOL = 1e-6
CHANNELS = 8


def _randomize_bn(variables, seed):
    """Random BN scale/bias and running statistics, away from identity."""
    rng = np.random.default_rng(seed)
    draw = {"scale": lambda s: rng.uniform(0.5, 1.5, s), "var": lambda s: rng.uniform(0.5, 1.5, s),
            "bias": lambda s: rng.normal(0, 0.2, s), "mean": lambda s: rng.normal(0, 0.2, s)}

    def walk(tree, in_bn=False):
        return {key: walk(value, key.startswith("BatchNorm_")) if isinstance(value, dict)
                else (draw[key](np.shape(value)).astype(np.float32) if in_bn
                      else np.asarray(value))
                for key, value in tree.items()}

    return {"params": walk(variables["params"]), "batch_stats": walk(variables["batch_stats"])}


def _running_stats(state):
    return {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}


def _check_stats(module, params, new_stats):
    """The port's running statistics after its forward against flax's
    updated batch_stats, carried over by params_from_jax's names."""
    want = _running_stats(params_from_jax({"params": params, "batch_stats": new_stats}))
    got = _running_stats(module.state_dict())
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=STATS_RTOL,
                                   atol=0, err_msg=name)


def test_residual_block_train_mode_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3, 3, CHANNELS)).astype(np.float32)  # NHWC
    jblock = JaxResidualBlock(CHANNELS)
    variables = jax.tree_util.tree_map(
        np.asarray, jblock.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    variables = _randomize_bn(variables, 2)
    want, mut = jblock.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])

    block = ResidualBlock(CHANNELS)
    block.load_state_dict(params_from_jax(variables))
    block.train()
    with torch.no_grad():
        got = block(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)
    _check_stats(block, variables["params"], mut["batch_stats"])


def test_batch_norm_running_var_is_biased():
    """One batch of n = 4 * 3 * 3 = 36 values a channel: the running
    variance takes the biased batch variance (flax), not the unbiased one
    (nn.BatchNorm2d's update, 36/35 larger)."""
    block = ResidualBlock(CHANNELS)
    bn = block.BatchNorm_0.train()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, CHANNELS, 3, 3))
                         .astype(np.float32))
    with torch.no_grad():
        bn(x)
    biased = x.permute(1, 0, 2, 3).reshape(CHANNELS, -1).var(dim=1, correction=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased, rtol=STATS_RTOL, atol=0)
    assert int(bn.num_batches_tracked) == 1


def _resnet_pair():
    jcfg, tcfg = JaxTicTacToe(), TicTacToe()
    for cfg in (jcfg, tcfg):
        cfg.blocks, cfg.channels = 2, CHANNELS
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, runner.init(jax.random.PRNGKey(4)))
    variables = _randomize_bn(variables, 5)
    net = MuZeroNetwork(tcfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    return runner, variables, net.train()


@pytest.mark.parametrize("part", ["representation", "dynamics"])
def test_resnet_train_mode_matches_flax(part):
    """The whole representation or dynamics ResNet (2 blocks, 8 channels),
    one train-mode forward each: outputs and every updated running
    statistic of the batch norms it runs."""
    runner, variables, net = _resnet_pair()
    module = runner.module
    rng = np.random.default_rng(6)
    B = 4
    if part == "representation":
        obs = (rng.random((B,) + runner.stacked_observation_shape()) < 0.4).astype(np.float32)
        want, mut = module.apply(variables, jnp.asarray(obs), train=True,
                                 method=module.representation, mutable=["batch_stats"])
        with torch.no_grad():
            got = net.representation(torch.from_numpy(obs))
        pairs = [(got.permute(0, 2, 3, 1), want)]
    else:
        hidden = rng.random((B, 3, 3, CHANNELS)).astype(np.float32)  # NHWC
        actions = rng.integers(0, 9, size=(B,)).astype(np.int32)
        want, mut = module.apply(variables, jnp.asarray(hidden), jnp.asarray(actions),
                                 train=True, method=module.dynamics, mutable=["batch_stats"])
        with torch.no_grad():
            got = net.dynamics(torch.from_numpy(hidden.transpose(0, 3, 1, 2).copy()),
                               torch.from_numpy(actions))
        pairs = [(got[0].permute(0, 2, 3, 1), want[0]), (got[1], want[1])]
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OUT_ATOL, rtol=0)
    _check_stats(net, variables["params"], mut["batch_stats"])
