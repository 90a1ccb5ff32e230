"""The port's networks and self-play driver at compute_dtype "bfloat16"
against the JAX package's, with the same weights (params_from_jax).

Three ResNet variants, as the JAX package runs them: unfolded (bf16
products, float32 activations and batch norms), folded (the BN-folded twin,
float32 activations) and folded with search_bf16_activations (conv
pipeline, hidden normalization and hidden state in bfloat16). Each on a
seeded 2-block x 16-channel net with randomized batch norms and on the
shipped connect4 checkpoint; all four outputs of both inferences.

Tolerances. A bfloat16 product is exact in float32 and both frameworks
accumulate in float32, so layer outputs agree up to the float32 sum order
before their rounding to bfloat16; where that order flips a rounding, an
output moves by one bfloat16 ulp (2^-8 relative). Logits are held to
LOGIT_TOL = 4e-3 of the batch's largest |logit|, one bfloat16 ulp there
(observed: 0.0, and one policy logit of the connect4 net unfolded off by
7.8e-3 of 8.5); hidden states, min-max normalized to [0, 1], to HIDDEN_TOL
= 4e-3, one bfloat16 ulp below 1 (observed <= 6.3e-7 in float32, 0.0 in
bfloat16).
"""

import jax
import numpy as np
import pytest
import torch

from muzero_general_tpu.games.cartpole import MuZeroConfig as JaxCartpole
from muzero_general_tpu.games.connect4 import MuZeroConfig as JaxConnect4
from muzero_general_tpu.games.tictactoe import MuZeroConfig as JaxTicTacToe
from muzero_general_tpu.games.tictactoe import make_env as jax_tictactoe_env
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.selfplay import SelfPlayDriver as JaxDriver
from muzero_general_tpu_torch import checkpoint as torch_checkpoint
from muzero_general_tpu_torch.games.cartpole import MuZeroConfig as Cartpole
from muzero_general_tpu_torch.games.cartpole import make_env as make_cartpole_env
from muzero_general_tpu_torch.games.connect4 import MuZeroConfig as Connect4
from muzero_general_tpu_torch.games.tictactoe import MuZeroConfig as TicTacToe
from muzero_general_tpu_torch.games.tictactoe import make_env as tictactoe_env
from muzero_general_tpu_torch.models import (
    MuZeroNetwork,
    activation_dtype,
    fold_bn,
    params_from_jax,
)
from muzero_general_tpu_torch.ops import mcts as mcts_ops
from muzero_general_tpu_torch.ops.stacking import stack_observations
from muzero_general_tpu_torch.ops.support import support_to_scalar
from muzero_general_tpu_torch.selfplay import SelfPlayDriver

LOGIT_TOL = 4e-3  # see the module docstring
HIDDEN_TOL = 4e-3
CHECKPOINT = "pretrained/connect4/model.checkpoint"


def _bf16(cfg, acts=False):
    cfg.compute_dtype = "bfloat16"
    cfg.search_bf16_activations = acts
    return cfg


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


def _to_torch(x):
    """A JAX array (float32 or bfloat16) -> a torch tensor of the same dtype."""
    x = np.array(x)  # a writable, contiguous copy
    if x.dtype == np.float32 or x.dtype.kind in "iub":
        return torch.from_numpy(x)
    return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)


def _check(got, want):
    for name, g, w in zip(("value", "reward", "policy", "hidden"), got, want):
        w = np.asarray(w)
        if name == "hidden":
            assert g.dtype == _to_torch(w).dtype, (g.dtype, w.dtype)
            g = g.permute(0, 2, 3, 1) if g.dim() == 4 else g  # NCHW -> JAX's NHWC
            np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                       atol=HIDDEN_TOL, rtol=0, err_msg=name)
        else:
            assert g.dtype == torch.float32, (name, g.dtype)
            w = w.astype(np.float32)
            if name == "reward" and w.max() == 0.0:  # the initial log one-hot
                np.testing.assert_array_equal(g.numpy(), w)
                continue
            scale = np.abs(w).max()
            np.testing.assert_allclose(g.numpy(), w, atol=LOGIT_TOL * scale, rtol=0,
                                       err_msg=name)


def _resnet_variables(source):
    if source == "connect4":
        return JaxConnect4, Connect4, torch_checkpoint.load_checkpoint(CHECKPOINT)["weights"]

    def configure(cls):
        def make():
            cfg = cls()
            cfg.blocks, cfg.channels = 2, 16
            return cfg
        return make

    jax_cls, torch_cls = configure(JaxTicTacToe), configure(TicTacToe)
    variables = jax.tree_util.tree_map(
        np.asarray, JaxNetwork(_bf16(jax_cls())).init(jax.random.PRNGKey(8)))
    return jax_cls, torch_cls, _randomize_bn(variables, 9)


@pytest.mark.parametrize("variant", ["unfolded", "folded", "folded_bf16_acts"])
@pytest.mark.parametrize("source", ["random_2x16", "connect4"])
def test_resnet_bf16_matches_jax(source, variant):
    jax_cls, torch_cls, variables = _resnet_variables(source)
    acts = variant == "folded_bf16_acts"
    jcfg, tcfg = _bf16(jax_cls(), acts), _bf16(torch_cls(), acts)
    runner = JaxNetwork(jcfg)
    net = MuZeroNetwork(tcfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    if variant == "unfolded":
        module, v = net, variables
        initial, recurrent = runner.initial_inference, runner.recurrent_inference
    else:
        module, v = fold_bn(net, activation_dtype(tcfg)), runner.fold_variables(variables)
        initial, recurrent = runner.initial_inference_folded, runner.recurrent_inference_folded
    # The weights are float32 in the module and bfloat16 at use.
    assert all(p.dtype == torch.float32 for p in module.parameters())
    rng = np.random.default_rng(10)
    B = 6
    obs = (rng.random((B,) + runner.stacked_observation_shape()) < 0.4).astype(np.float32)
    actions = rng.integers(0, len(jcfg.action_space), size=(B,)).astype(np.int32)
    with torch.no_grad():
        want = initial(v, obs)
        got = module.initial_inference(torch.from_numpy(obs))
        _check(got, want)
        assert got[3].dtype == (torch.bfloat16 if acts else torch.float32)
        hidden = np.asarray(want[3])
        want = recurrent(v, hidden, actions)
        got = module.recurrent_inference(_to_torch(hidden.transpose(0, 3, 1, 2)),
                                         torch.from_numpy(actions))
        _check(got, want)


def test_fc_bf16_matches_jax():
    """The FC net at bf16: bf16 products, float32 outputs and hidden state."""
    jcfg, tcfg = _bf16(JaxCartpole()), _bf16(Cartpole())
    for cfg in (jcfg, tcfg):
        cfg.fc_representation_layers = [32]
        cfg.fc_dynamics_layers = cfg.fc_reward_layers = [32]
        cfg.fc_value_layers = cfg.fc_policy_layers = [32]
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(np.asarray, runner.init(jax.random.PRNGKey(11)))
    net = MuZeroNetwork(tcfg, device="cpu")
    net.load_state_dict(params_from_jax(variables["params"]))
    rng = np.random.default_rng(12)
    B = 16
    obs = rng.normal(size=(B,) + runner.stacked_observation_shape()).astype(np.float32)
    actions = rng.integers(0, 2, size=(B,)).astype(np.int32)
    with torch.no_grad():
        want = runner.initial_inference(variables, obs)
        _check(net.initial_inference(torch.from_numpy(obs)), want)
        hidden = np.asarray(want[3])
        want = runner.recurrent_inference(variables, hidden, actions)
        _check(net.recurrent_inference(_to_torch(hidden), torch.from_numpy(actions)), want)


def test_fc_bf16_driver_runs_the_fused_search():
    """FC nets at bf16 through SelfPlayDriver: the fused search (its plain
    version on the CPU) takes the float32 parameters, as the JAX package's
    run_mcts_fused does; only the root's initial inference runs in bf16, so
    the records' predicted values are the bf16 net's."""
    cfg = _bf16(Cartpole())
    cfg.parallel_games, cfg.num_simulations = 4, 8
    net = MuZeroNetwork(cfg, device="cpu", seed=3)
    driver = SelfPlayDriver(make_cartpole_env(device="cpu"), net, cfg, seed=0, device="cpu")
    assert driver.use_fused
    driver.reset()
    stacked = stack_observations(driver._carry.obs_hist, driver._carry.act_hist, driver.A)
    with torch.no_grad():
        value_logits = net.initial_inference(stacked)[0]
    rec = driver.play_chunk(1.0, 2)
    assert rec.child_visits.shape == (2, 4, 2)
    assert bool(((rec.child_visits.sum(-1) - 1).abs() < 1e-6).all())
    np.testing.assert_array_equal(
        rec.pred_value[0].numpy(), support_to_scalar(value_logits, cfg.support_size).numpy())


def _tictactoe_config(cls, acts):
    cfg = _bf16(cls(), acts)
    cfg.num_simulations = 25
    cfg.parallel_games = 8
    cfg.selfplay_chunk_moves = 9
    return cfg


@pytest.fixture(scope="module")
def jax_bf16_driver_records():
    """The JAX driver at bf16 with bf16 search activations on tictactoe (XLA
    search, deterministic ties, temperature 0, no noise): its weights and
    its MoveRecord, per activation dtype."""
    out = {}
    for acts in (False, True):
        jcfg = _tictactoe_config(JaxTicTacToe, acts)
        runner = JaxNetwork(jcfg)
        variables = jax.tree_util.tree_map(np.asarray, runner.init(jax.random.PRNGKey(3)))
        variables = _randomize_bn(variables, 13)
        jd = JaxDriver(jax_tictactoe_env(), runner, jcfg, seed=0)
        assert not jd.use_fused and not jd.spec.use_pallas and jd.fold_bn
        jd.spec = jd.spec._replace(deterministic_tie_break=True)
        jd._build()
        jd._rng, k = jax.random.split(jd._rng)
        carry = jd._init_carry(jax.random.split(k, 1))
        temps = np.zeros((jcfg.parallel_games,), np.float32)
        # XLA's default lets a jitted program keep a layer's bf16 output in
        # float32 where a float32 op reads it (excess precision), which
        # eager JAX and the port do not: both round where the JAX package's
        # code casts (`.astype`). Compiled without it, the JAX driver
        # computes what its source states, and its network outputs equal
        # the port's bit for bit.
        fn = jd._get_play_chunk(jcfg.selfplay_chunk_moves, False)
        fn = fn.lower(variables, carry, temps).compile(
            compiler_options={"xla_allow_excess_precision": False})
        _, want = fn(variables, carry, temps)
        out[acts] = variables, jax.tree_util.tree_map(np.asarray, want)
    return out


@pytest.mark.parametrize("route", ["plain", "kernels", "stream"])
@pytest.mark.parametrize("acts", [False, True], ids=["f32_acts", "bf16_acts"])
def test_driver_bf16_matches_jax_driver(jax_bf16_driver_records, route, acts, monkeypatch):
    """SelfPlayDriver at bf16 on tictactoe (its 1 x 16 ResNet, randomized
    batch norms, BN folded on both sides) against the JAX driver's XLA path,
    move for move until each lane's first done. The port runs each of its
    three search routes (the kernel and stream routes through the kernels'
    plain versions on the CPU): the same search, so each must match JAX.
    Discrete fields exactly; values to VALUE_TOL = 1e-4, as the float32
    driver test (tests/test_torch_selfplay.py): the network outputs agree
    bit for bit here, and the support decode and the tree's sums add their
    float32 rounding."""
    variables, want = jax_bf16_driver_records[acts]
    cfg = _tictactoe_config(TicTacToe, acts)
    K, G = cfg.selfplay_chunk_moves, cfg.parallel_games
    net = MuZeroNetwork(cfg, device="cpu")
    net.load_state_dict(params_from_jax(variables))
    driver = SelfPlayDriver(tictactoe_env(device="cpu"), net, cfg, seed=0, device="cpu")
    assert driver.fold_bn and driver.act_dtype == (torch.bfloat16 if acts else torch.float32)
    driver.spec = driver.spec._replace(deterministic_tie_break=True,
                                       use_kernels=route == "kernels",
                                       use_stream=route == "stream")
    hidden_dtypes = []
    run_mcts = mcts_ops.run_mcts

    def recording_run_mcts(*args, **kwargs):
        out = run_mcts(*args, **kwargs)
        hidden_dtypes.append(out.root_hidden.dtype)
        return out

    monkeypatch.setattr(mcts_ops, "run_mcts", recording_run_mcts)
    got = driver.play_chunk(torch.zeros((G,)), K, add_noise=False)
    assert set(hidden_dtypes) == {torch.bfloat16 if acts else torch.float32}
    got = type(got)(*(f.numpy() for f in got))
    first_done = np.where(want.done.any(0), want.done.argmax(0), K - 1)
    live = np.arange(K)[:, None] <= first_done[None, :]
    assert live.sum() >= 5 * G and want.done.any(0).all()
    for name in ("done", "action", "child_visits", "reward", "to_play", "to_play_next",
                 "max_tree_depth", "observation"):
        np.testing.assert_array_equal(getattr(got, name)[live], getattr(want, name)[live],
                                      err_msg=name)
    for name in ("root_value", "pred_value"):
        np.testing.assert_allclose(getattr(got, name)[live], getattr(want, name)[live],
                                   atol=1e-4, rtol=0, err_msg=name)
