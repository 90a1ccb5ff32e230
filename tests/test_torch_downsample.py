"""The port's downsampled ResNets (models/resnet.py DownSampleResnet,
DownsampleCNN) against the JAX package's, at breakout's 96 x 96 observation.

A small net (1 block, 8 channels, heads of 2 channels) from a JAX init with
randomized batch norms, carried into the port with params_from_jax; the
same numpy inputs on both sides:
- inference, unfolded and folded (fold_bn against fold_bn_variables), to
  ATOL = 1e-5 in float32 (15 convs of the pyramid summed in another order,
  then a min-max normalize; observed <= 4.7e-6); in bfloat16, logits to
  tests/test_torch_bf16.py's LOGIT_TOL (one bf16 ulp of the largest) and
  hidden states to BF16_HIDDEN_TOL = 8e-3, two bf16 ulps below 1: both
  frameworks round where the source casts (the average pool's bf16 sum
  included), but the pyramid's first conv alone rounds 73,728 outputs a
  frame, summed in another order, so some rounding flips by one ulp, and
  the flip passes through up to 14 more bf16-rounded convs and the min-max
  normalize (observed 4.7e-3 in 3 of 576 hidden values, unfolded "resnet";
  0.0 in the folded variants);
- the train-mode forward's running statistics, to rtol 1e-4 (flax takes
  the variance as E[x^2] - E[x]^2, ROADMAP queue 3);
- every parameter carried both ways;
- the staged search on the net, both routes (the kernel route through the
  kernels' plain versions, JAX's Pallas kernels in interpret mode), with
  first-index ties and injected noise: visits, depth and tree shape exact,
  root values to ROOT_ATOL = 5e-5;
- one learner step (SGD at lr 1, so the step is the gradient), at
  tests/test_torch_trainer.py's tolerances for losses, priorities and
  running statistics, and its GRAD_RTOL and GRAD_SCALE_TOL for gradients,
  the latter of the tree's largest gradient rather than the leaf's: the
  backward through the pyramid's 16 batch norms (which subtract means)
  carries the absolute error of the large terms into leaves of 4 small
  gradients (observed 3.8e-6 of a largest 0.66 for "resnet", 1.5e-6 for
  "CNN"; the leaf-relative bound failed at 4.8e-7 on a leaf whose largest
  gradient is 0.029).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.games.breakout import MuZeroConfig as JaxBreakout
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.models.network import fold_bn_variables
from muzero_general_tpu.ops import mcts as jax_mcts
from muzero_general_tpu.trainer import make_train_step
from muzero_general_tpu_torch.games.breakout import MuZeroConfig as Breakout
from muzero_general_tpu_torch.models import (
    MuZeroNetwork,
    activation_dtype,
    fold_bn,
    params_from_jax,
    params_to_jax,
)
from muzero_general_tpu_torch.models.resnet import hidden_hw
from muzero_general_tpu_torch.ops import mcts as torch_mcts
from test_torch_bf16 import LOGIT_TOL, _to_torch
from test_torch_resnet import _randomize_bn
from test_torch_trainer import (
    GRAD_RTOL,
    GRAD_SCALE_TOL,
    LOSS_ATOL,
    LOSS_RTOL,
    PRIO_ATOL,
    PRIO_RTOL,
    STATS_ATOL,
    STATS_RTOL,
    _leaves,
    assert_trees_close,
    fake_batch,
    setup,
)

ATOL = 1e-5  # see the module docstring
BF16_HIDDEN_TOL = 8e-3
ROOT_ATOL = 5e-5
DOWNSAMPLERS = ["resnet", "CNN"]
SMALL = dict(blocks=1, channels=8, reduced_channels_reward=2, reduced_channels_value=2,
             reduced_channels_policy=2, resnet_fc_reward_layers=[8],
             resnet_fc_value_layers=[8], resnet_fc_policy_layers=[8])


def _configs(downsample, **overrides):
    jcfg, cfg = JaxBreakout(), Breakout()
    for c in (jcfg, cfg):
        for key, value in dict(SMALL, downsample=downsample, **overrides).items():
            setattr(c, key, value)
    return jcfg, cfg


def _pair(downsample, seed=1, **overrides):
    """(JAX runner, its variables, the port's net with the same weights)."""
    jcfg, cfg = _configs(downsample, **overrides)
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, runner.init(jax.random.PRNGKey(seed)))
    if variables.get("batch_stats"):
        variables = _randomize_bn(variables, seed + 1)
    net = MuZeroNetwork(cfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    return runner, variables, net, cfg


def _observations(B, seed):
    """Breakout frames: sparse pixels in [0, 1], as the env draws them."""
    rng = np.random.default_rng(seed)
    obs = rng.random((B, 3, 96, 96)).astype(np.float32)
    return np.where(rng.random(obs.shape) < 0.3, obs, 0.0).astype(np.float32)


def _check_f32(got, want):
    for name, g, w in zip(("value", "reward", "policy", "hidden"), got, want):
        g = g.permute(0, 2, 3, 1).numpy() if name == "hidden" else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0, err_msg=name)


def _check_bf16(got, want):
    """test_torch_bf16._check with the hidden states at BF16_HIDDEN_TOL."""
    for name, g, w in zip(("value", "reward", "policy", "hidden"), got, want):
        w = np.asarray(w)
        if name == "hidden":
            assert g.dtype == _to_torch(w).dtype, (g.dtype, w.dtype)
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).float().numpy(),
                                       w.astype(np.float32), atol=BF16_HIDDEN_TOL, rtol=0)
            continue
        assert g.dtype == torch.float32, (name, g.dtype)
        w = w.astype(np.float32)
        np.testing.assert_allclose(g.numpy(), w, atol=LOGIT_TOL * np.abs(w).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("downsample", DOWNSAMPLERS)
def test_downsampled_net_matches_jax(downsample):
    runner, variables, net, cfg = _pair(downsample)
    obs = _observations(2, 3)
    actions = np.array([1, 3], np.int32)
    folded = fold_bn(net)
    fvars = runner.fold_variables(variables)
    with torch.no_grad():
        for module, initial, recurrent, v in (
            (net, runner.initial_inference, runner.recurrent_inference, variables),
            (folded, runner.initial_inference_folded, runner.recurrent_inference_folded,
             fvars),
        ):
            want = initial(v, obs)
            got = module.initial_inference(torch.from_numpy(obs))
            assert got[3].shape == (2, 8) + hidden_hw(cfg.observation_shape, downsample)
            assert got[3].shape[2:] == (6, 6)
            _check_f32(got, want)
            hidden = np.array(want[3])
            want = recurrent(v, hidden, actions)
            got = module.recurrent_inference(
                torch.from_numpy(hidden.transpose(0, 3, 1, 2).copy()),
                torch.from_numpy(actions))
            _check_f32(got, want)


@pytest.mark.parametrize("downsample", DOWNSAMPLERS)
def test_params_carry_both_ways_and_fold_matches_jax(downsample):
    runner, variables, net, _ = _pair(downsample)
    # Every leaf maps onto the module, and back unchanged.
    assert set(params_from_jax(variables)) == set(net.state_dict())
    back = params_to_jax(net)
    for key in ("params", "batch_stats"):
        want = dict(_leaves(variables.get(key, {})))
        got = dict(_leaves(back[key]))
        assert got.keys() == want.keys(), key
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # The folded twin's tree is fold_bn_variables' (the pyramid's stride-2
    # convs stay unbiased, its residual blocks fold).
    folded = params_to_jax(fold_bn(net))
    assert folded["batch_stats"] == {}
    want = dict(_leaves(fold_bn_variables(variables)["params"]))
    got = dict(_leaves(folded["params"]))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-6, rtol=1e-6, err_msg=name)
    if downsample == "resnet":
        pyramid = "representation_network.DownSampleResnet_0"
        assert f"{pyramid}.TorchConv_0.kernel" in got and f"{pyramid}.TorchConv_0.bias" not in got
        assert f"{pyramid}.ResidualBlock_7.TorchConv_1.bias" in got
        assert not any("BatchNorm" in name for name in got)


@pytest.mark.parametrize("variant", ["unfolded", "folded", "folded_bf16_acts"])
@pytest.mark.parametrize("downsample", DOWNSAMPLERS)
def test_downsampled_net_bf16_matches_jax(downsample, variant):
    acts = variant == "folded_bf16_acts"
    runner, variables, net, cfg = _pair(downsample, seed=4, compute_dtype="bfloat16",
                                        search_bf16_activations=acts)
    if variant == "unfolded":
        module, v = net, variables
        initial, recurrent = runner.initial_inference, runner.recurrent_inference
    else:
        module, v = fold_bn(net, activation_dtype(cfg)), runner.fold_variables(variables)
        initial, recurrent = runner.initial_inference_folded, runner.recurrent_inference_folded
    obs = _observations(2, 5)
    actions = np.array([0, 2], np.int32)
    with torch.no_grad():
        want = initial(v, obs)
        got = module.initial_inference(torch.from_numpy(obs))
        _check_bf16(got, want)
        hidden = np.asarray(want[3])
        want = recurrent(v, hidden, actions)
        got = module.recurrent_inference(_to_torch(hidden.transpose(0, 3, 1, 2)),
                                         torch.from_numpy(actions))
        _check_bf16(got, want)


@pytest.mark.parametrize("downsample", DOWNSAMPLERS)
def test_train_mode_running_statistics_match_flax(downsample):
    runner, variables, net, _ = _pair(downsample, seed=6)
    obs = _observations(4, 7)
    (_, new_stats) = runner.initial_inference_train(variables, obs)
    net.train()
    net.initial_inference(torch.from_numpy(obs))
    got = params_to_jax(net)["batch_stats"]
    want = jax.tree_util.tree_map(np.asarray, dict(new_stats["batch_stats"]))
    if downsample == "CNN":  # the CNN downsampler has no batch norm
        assert "DownsampleCNN_0" not in got["representation_network"]
    assert_trees_close(got, want, STATS_ATOL, STATS_RTOL, what="batch_stats")
    moved = [n for n, x in _leaves(got)
             if not np.array_equal(x, dict(_leaves(variables["batch_stats"]))[n])]
    assert any("representation_network" in n for n in moved)


@pytest.mark.parametrize("kernels", [False, True])
def test_search_on_a_downsampled_net_matches_jax(kernels):
    """B = 2 roots, 8 simulations, 4 actions, one illegal; the folded net as
    self-play runs it."""
    runner, variables, net, cfg = _pair("resnet", seed=8)
    folded, fvars = fold_bn(net), runner.fold_variables(variables)
    B, A, sims = 2, 4, 8
    common = dict(num_simulations=sims, num_players=1, pb_c_base=19652.0, pb_c_init=1.25,
                  discount=0.997, dirichlet_alpha=0.25, exploration_fraction=0.25,
                  support_size=cfg.support_size, max_depth=sims,
                  deterministic_tie_break=True)
    jspec = jax_mcts.SearchSpec(**common, use_pallas=kernels, pallas_interpret=kernels)
    tspec = torch_mcts.SearchSpec(**common, use_kernels=kernels)
    obs = _observations(B, 9)
    legal = np.ones((B, A), bool)
    legal[1, 2] = False
    to_play = np.zeros(B, np.int32)
    rng = jax.random.PRNGKey(10)
    want = jax_mcts.run_mcts(
        lambda o: runner.initial_inference_folded(fvars, o),
        lambda h, a: runner.recurrent_inference_folded(fvars, h, a),
        jnp.asarray(obs), jnp.asarray(legal), jnp.asarray(to_play), rng, jspec,
        add_exploration_noise=True)
    gamma = np.array(jax.random.gamma(jax.random.fold_in(rng, 0), jspec.dirichlet_alpha,
                                      (B, A)))
    with torch.no_grad():
        got = torch_mcts.run_mcts(
            folded.initial_inference, folded.recurrent_inference, torch.from_numpy(obs),
            torch.from_numpy(legal), torch.from_numpy(to_play),
            torch.Generator().manual_seed(0), tspec, add_exploration_noise=True,
            root_noise=torch.from_numpy(gamma), seed=0)
    np.testing.assert_array_equal(got.root_visit_counts.numpy(),
                                  np.asarray(want.root_visit_counts))
    np.testing.assert_array_equal(got.max_tree_depth.numpy(), np.asarray(want.max_tree_depth))
    for name in ("children_index", "children_visit", "root_visit"):
        np.testing.assert_array_equal(getattr(got.tree, name).numpy(),
                                      np.asarray(getattr(want.tree, name)), err_msg=name)
    np.testing.assert_allclose(got.root_value.numpy(), np.asarray(want.root_value),
                               atol=ROOT_ATOL, rtol=0)
    assert int(got.root_visit_counts[1, 2]) == 0
    assert got.root_hidden.shape == (B, 8, 6, 6)


@pytest.mark.parametrize("downsample", DOWNSAMPLERS)
def test_learner_step_on_a_downsampled_net_matches_jax(downsample):
    """One PER step at batch 4, unroll 3, on 96 x 96 frames: SGD at lr 1 with
    no momentum and no decay, so params_before - params_after is the
    gradient (tests/test_torch_trainer.py test_gradients_match_jax)."""
    kw = dict(optimizer="SGD", lr_init=1.0, lr_decay_rate=1.0, momentum=0.0,
              weight_decay=0.0, PER=True, observation_shape=(3, 96, 96),
              action_space=list(range(4)), downsample=downsample)
    jcfg, runner, state, learner = setup("resnet", **kw)
    before = params_to_jax(learner.network)["params"]
    batch = fake_batch(jcfg, 11)
    batch["observation"] = _observations(jcfg.batch_size, 12)
    jstate, jm, jp = make_train_step(runner, jcfg, donate=False)(
        state, {k: jnp.asarray(v.copy()) for k, v in batch.items()})
    tm, tp = learner.train_step(batch)
    for key in ("total_loss", "value_loss", "reward_loss", "policy_loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=key)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=PRIO_RTOL, atol=PRIO_ATOL)
    after = params_to_jax(learner.network)
    jax_after = dict(_leaves(jstate.params))
    got_after = dict(_leaves(after["params"]))
    grads = {name: p0 - jax_after[name] for name, p0 in _leaves(before)}
    atol = GRAD_SCALE_TOL * max(np.abs(g).max() for g in grads.values())
    for name, p0 in _leaves(before):
        np.testing.assert_allclose(p0 - got_after[name], grads[name], rtol=GRAD_RTOL,
                                   atol=atol, err_msg=name)
    assert_trees_close(after["batch_stats"], jstate.batch_stats, STATS_ATOL, STATS_RTOL,
                       what="batch_stats")
