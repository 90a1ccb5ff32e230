"""The port's ResNet (models/resnet.py), its BN fold and its weight carry
against the JAX package's NetworkRunner.

The same flax variables (a random init with randomized batch-norm
statistics at tictactoe size, and the shipped connect4 checkpoint) are
carried into the port with params_from_jax; both networks get the same numpy
inputs. The port's hidden states are NCHW and are permuted to the JAX
package's NHWC for the compare. Outputs agree to ATOL = 5e-5: float32
convolutions and dense layers summed in another order (up to 64 x 9
products per output), through up to seven residual convs, then a min-max
normalize that divides by the per-channel range (observed <= 8.1e-6 on the
checkpoint). The folded variants
(fold_bn vs fold_bn_variables) are held to the same tolerance, against the
JAX package's folded runner and against the unfolded port.
"""

import jax
import numpy as np
import pytest
import torch

from muzero_general_tpu.games.connect4 import MuZeroConfig as JaxConnect4
from muzero_general_tpu.games.tictactoe import MuZeroConfig as JaxTicTacToe
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu_torch import checkpoint as torch_checkpoint
from muzero_general_tpu_torch.games.connect4 import MuZeroConfig as Connect4
from muzero_general_tpu_torch.games.tictactoe import MuZeroConfig as TicTacToe
from muzero_general_tpu_torch.models import MuZeroNetwork, fold_bn, params_from_jax

ATOL = 5e-5  # see the module docstring
CHECKPOINT = "pretrained/connect4/model.checkpoint"


def _randomize_bn(variables, seed):
    """Random BN scale/bias and running stats, so the fold is not identity."""
    rng = np.random.default_rng(seed)
    draw = {"scale": lambda s: rng.uniform(0.5, 1.5, s), "var": lambda s: rng.uniform(0.5, 1.5, s),
            "bias": lambda s: rng.normal(0, 0.2, s), "mean": lambda s: rng.normal(0, 0.2, s)}

    def walk(tree, in_bn=False):
        return {
            key: walk(value, key.startswith("BatchNorm_")) if isinstance(value, dict)
            else (draw[key](np.shape(value)).astype(np.float32) if in_bn
                  else np.asarray(value))
            for key, value in tree.items()
        }

    return {"params": walk(variables["params"]),
            "batch_stats": walk(variables["batch_stats"])}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _check(got, want):
    for name, g, w in zip(("value", "reward", "policy", "hidden"), got, want):
        g = _nhwc(g) if name == "hidden" else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0, err_msg=name)


def _compare(jcfg, tcfg, variables, seed, B=6):
    runner = JaxNetwork(jcfg)
    net = MuZeroNetwork(tcfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    folded = fold_bn(net)
    fvars = runner.fold_variables(variables)
    rng = np.random.default_rng(seed)
    obs = (rng.random((B,) + runner.stacked_observation_shape()) < 0.4).astype(np.float32)
    actions = rng.integers(0, len(jcfg.action_space), size=(B,)).astype(np.int32)
    with torch.no_grad():
        for module, initial, recurrent, v in (
            (net, runner.initial_inference, runner.recurrent_inference, variables),
            (folded, runner.initial_inference_folded, runner.recurrent_inference_folded,
             fvars),
        ):
            want = initial(v, obs)
            _check(module.initial_inference(torch.from_numpy(obs)), want)
            hidden = np.asarray(want[3])
            want = recurrent(v, hidden, actions)
            _check(module.recurrent_inference(_nchw(hidden), torch.from_numpy(actions)),
                   want)
        # The folded module computes the unfolded one's function.
        t_obs = torch.from_numpy(obs)
        for g, w in zip(folded.initial_inference(t_obs), net.initial_inference(t_obs)):
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    return net


def test_resnet_matches_jax_random_init_tictactoe():
    jcfg, tcfg = JaxTicTacToe(), TicTacToe()
    variables = jax.tree_util.tree_map(np.asarray, JaxNetwork(jcfg).init(jax.random.PRNGKey(4)))
    _compare(jcfg, tcfg, _randomize_bn(variables, 5), seed=6)


def test_resnet_matches_jax_pretrained_connect4():
    """The shipped 3 x 64 checkpoint: also catches a wrong flatten order in
    the heads (the dense kernels' rows are in the JAX (h, w, c) order) and
    a misplaced action plane."""
    variables = torch_checkpoint.load_checkpoint(CHECKPOINT)["weights"]
    assert set(variables) == {"params", "batch_stats"}
    _compare(JaxConnect4(), Connect4(), variables, seed=7, B=4)


def test_params_from_jax_maps_every_resnet_leaf():
    variables = torch_checkpoint.load_checkpoint(CHECKPOINT)["weights"]
    state = params_from_jax(variables)
    net = MuZeroNetwork(Connect4(), device="cpu")
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)
    dyn = variables["params"]["dynamics_network"]
    kernel = np.asarray(dyn["TorchConv_0"]["kernel"])
    assert kernel.shape == (3, 3, 65, 64)  # HWIO, 64 channels + the action plane
    np.testing.assert_array_equal(
        state["dynamics_network.TorchConv_0.weight"].numpy(), kernel.transpose(3, 2, 0, 1))
    stats = variables["batch_stats"]["representation_network"]["BatchNorm_0"]
    np.testing.assert_array_equal(
        state["representation_network.BatchNorm_0.running_var"].numpy(), stats["var"])


def test_resnet_refuses_what_is_not_ported():
    """Both downsamplers are ported (tests/test_torch_downsample.py); any
    other downsample value raises the JAX package's message."""
    cfg = Connect4()
    for downsample in ("FFT", True):
        cfg.downsample = downsample
        with pytest.raises(NotImplementedError, match='downsample should be "resnet" or "CNN"'):
            MuZeroNetwork(cfg, device="cpu")
    cfg.downsample = False
    # bfloat16 is ported: the layers compute in it, the parameters stay float32.
    cfg.compute_dtype = "bfloat16"
    net = MuZeroNetwork(cfg, device="cpu")
    assert net.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_resnet_init_is_seeded_torch_conv_init():
    a = MuZeroNetwork(TicTacToe(), device="cpu", seed=1).state_dict()
    b = MuZeroNetwork(TicTacToe(), device="cpu", seed=1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["representation_network.TorchConv_0.weight"]
    assert w.shape == (16, 3, 3, 3)
    assert float(w.abs().max()) <= 1 / np.sqrt(3 * 9)  # TorchConv U(+-1/sqrt(fan_in))
    assert torch.equal(a["representation_network.BatchNorm_0.running_var"], torch.ones(16))
