"""The port's mesh (muzero_general_tpu_torch/parallel/mesh.py) against the
JAX package's, on gloo ranks on the CPU.

The ranks are processes started by the port's own launcher
(parallel.distributed.launch), one per mesh position, each on the CPU; they
run this file's module-level rank functions and import no JAX. This
process computes JAX's side on the 8 virtual CPU devices of
tests/conftest.py and the port's unsharded side, writes the inputs the
ranks read into an .npz file and holds the ranks' results against both:
- the rule: param_sharding shards exactly the layers JAX's rule shards
  (test_sharding.py's big_fc_config, 512-wide);
- mesh sizes: mesh_from_config returns None and raises as JAX's does;
- the FC step at (dp, mp) = (2, 1) and (2, 2), SGD without momentum,
  against JAX's single-device step and JAX's sharded step at
  test_sharding.py:69-104's tolerances (loss 1e-5 relative, priorities
  rtol 1e-4 atol 1e-5, updates rtol 5e-3 atol 1e-6);
- a 1-block ResNet step at dp = 2 (the global batch norm) and an M = 2
  fused FC step, against JAX's single-device step at
  test_torch_trainer.py's tolerances;
- the global batch norm equals one rank's on the whole batch where a
  channel's mean dwarfs its spread (E[x^2] - E[x]^2 would cancel there);
- the ranks' replicated parameters are bit-identical after the steps;
- the sharded self-play drivers (device and host) equal the port's
  unsharded driver lane for lane on injected draws (start states and
  resets for cartpole, root noise for lunarlander; temperature 0,
  first-index ties), exactly; a G that dp does not divide plays unsharded
  on rank 0;
- the reanalyse sweep split over dp gives the unsharded sweep's values;
- MuZero.train() on a device group of two CPU ranks, dp 2 (test_sharding.py
  :107-135's overrides and invariants) and mp 2.
"""

import functools

import numpy as np
import pytest
import torch

from muzero_general_tpu_torch.config import MuZeroConfig, load_game_module
from muzero_general_tpu_torch.envs.cartpole import CartPole
from muzero_general_tpu_torch.hostplay import HostSelfPlayDriver
from muzero_general_tpu_torch.models import MuZeroNetwork, params_to_jax
from muzero_general_tpu_torch.parallel import (
    create_mesh,
    make_sharded_fused_train_steps,
    make_sharded_train_step,
    mesh_from_config,
    param_sharding,
    shard_batch,
    shard_stacked_batches,
)
from muzero_general_tpu_torch.parallel import distributed as dist_lib
from muzero_general_tpu_torch.replay import GameHistory, ReplayBuffer
from muzero_general_tpu_torch.selfplay import SelfPlayDriver
from muzero_general_tpu_torch.trainer import Learner

# test_sharding.py:69-104
LOSS_REL, PRIO_RTOL, PRIO_ATOL, UPDATE_RTOL, UPDATE_ATOL = 1e-5, 1e-4, 1e-5, 5e-3, 1e-6
# test_torch_trainer.py's: losses, SGD params, batch statistics
T_LOSS_RTOL, T_LOSS_ATOL, T_PARAM_ATOL, STATS_RTOL, STATS_ATOL = 2e-5, 1e-5, 1e-5, 1e-4, 1e-5

ROOT_VALUE_ATOL = 1e-5
SP = dict(parallel_games=4, num_simulations=6, max_moves=6)  # self-play cases
SP_MOVES = 16


def big_fc_config(cls=MuZeroConfig):
    """test_sharding.py's big_fc_config, with SGD and no momentum or decay
    (an update linear in the gradient)."""
    c = cls()
    c.observation_shape = (1, 1, 8)
    c.action_space = list(range(4))
    c.encoding_size = 512
    c.fc_representation_layers = [512]
    c.fc_dynamics_layers = [512]
    c.fc_reward_layers = [64]
    c.fc_value_layers = [64]
    c.fc_policy_layers = [64]
    c.support_size = 10
    c.num_unroll_steps = 3
    c.batch_size = 16
    c.optimizer = "SGD"
    c.momentum = 0.0
    c.weight_decay = 0.0
    return c


def resnet_config(cls=MuZeroConfig):
    """test_torch_trainer.py's 1-block, 8-channel ResNet at tictactoe size,
    SGD, batch 4 (2 rows a rank at dp 2)."""
    c = cls()
    c.network = "resnet"
    c.observation_shape = (3, 3, 3)
    c.action_space = list(range(9))
    c.blocks = 1
    c.channels = 8
    c.reduced_channels_reward = c.reduced_channels_value = c.reduced_channels_policy = 2
    c.resnet_fc_reward_layers = c.resnet_fc_value_layers = c.resnet_fc_policy_layers = [8]
    c.support_size = 5
    c.num_unroll_steps = 3
    c.batch_size = 4
    c.optimizer = "SGD"
    return c


def fused_config(cls=MuZeroConfig):
    """A small FC net, Adam, batch 8: the M = 2 fused call."""
    c = cls()
    c.observation_shape = (1, 1, 4)
    c.action_space = list(range(2))
    c.encoding_size = 4
    c.fc_dynamics_layers = c.fc_reward_layers = [8]
    c.fc_value_layers = c.fc_policy_layers = [8]
    c.support_size = 5
    c.num_unroll_steps = 3
    c.batch_size = 8
    c.optimizer = "SGD"
    c.momentum = 0.9
    return c


CONFIGS = {"fc": big_fc_config, "resnet": resnet_config, "fused": fused_config}


def fake_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    B, U = cfg.batch_size, cfg.num_unroll_steps
    A = len(cfg.action_space)
    c, h, w = cfg.observation_shape
    n = cfg.stacked_observations
    return {
        "observation": rng.normal(size=(B, c * (n + 1) + n, h, w)).astype(np.float32),
        "action": rng.integers(0, A, (B, U + 1)).astype(np.int32),
        "target_value": (3 * rng.normal(size=(B, U + 1))).astype(np.float32),
        "target_reward": rng.normal(size=(B, U + 1)).astype(np.float32),
        "target_policy": rng.dirichlet(np.ones(A), (B, U + 1)).astype(np.float32),
        "weight": rng.uniform(0.2, 1.0, B).astype(np.float32),
        "gradient_scale": rng.integers(1, U + 1, (B, U + 1)).astype(np.float32),
    }


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}.")
        else:
            yield prefix + key, np.asarray(value)


# ---- the self-play cases' injected draws ---------------------------------

class FixedResetCartPole(CartPole):
    """Cartpole whose resets after a done start from one fixed state (the
    first reset's states are injected through driver.reset(start))."""

    def reset(self, num_games, generator=None, start=None):
        if start is None:
            start = torch.full((num_games, 4), 0.02)
        return super().reset(num_games, generator, start)


def cartpole_start(G):
    return torch.from_numpy(np.random.default_rng(7).uniform(-0.05, 0.05, (G, 4))
                            .astype(np.float32))


def lane_noise(A, alpha):
    """root_noise for the host driver: lane g's k-th draw depends on (g, k)
    only, so a shard draws what the unsharded driver draws for its lanes."""
    draws = {}

    def noise(lo, hi):
        rows = []
        for g in range(lo, hi):
            k = draws.get(g, 0)
            draws[g] = k + 1
            rows.append(np.random.default_rng([g, k]).gamma(alpha, 1.0, A))
        return np.stack(rows).astype(np.float32)

    return noise


def cartpole_driver(G, mesh=None, seed=0):
    cfg = MuZeroConfig()
    for key, value in dict(SP, parallel_games=G).items():
        setattr(cfg, key, value)
    net = MuZeroNetwork(cfg, device="cpu", seed=1)
    driver = SelfPlayDriver(FixedResetCartPole(device="cpu"), net, cfg, seed=seed,
                            greedy_lanes=1, device="cpu", mesh=mesh)
    driver.fused_spec = driver.fused_spec._replace(tie_jitter=0.0)
    driver.reset(start=cartpole_start(G))
    return driver


def lunarlander_driver(G, mesh=None, seed=0):
    module = load_game_module("lunarlander")
    cfg = module.MuZeroConfig()
    for key, value in dict(SP, parallel_games=G, num_simulations=4, max_moves=4).items():
        setattr(cfg, key, value)
    net = MuZeroNetwork(cfg, device="cpu", seed=1)
    driver = HostSelfPlayDriver(module.make_env, net, cfg, seed=seed, greedy_lanes=1,
                                device="cpu", mesh=mesh)
    driver.spec = driver.spec._replace(deterministic_tie_break=True)
    return driver


def play_games(driver, moves, host=False):
    """(completed, eval games, env_steps) of `moves` greedy moves in two
    play() calls, as plain arrays."""
    games, evals, steps = [], [], 0
    kw = dict(root_noise=lane_noise(driver.A, driver.spec.dirichlet_alpha)) if host else {}
    for _ in range(2):
        done, stats = driver.play(0.0, num_moves=moves // 2, **kw)
        games += done
        evals += stats["eval_games"]
        steps += stats["env_steps"]

    def arrays(gh):
        return (gh.observations, gh.actions, gh.rewards, gh.child_visits, gh.root_values,
                gh.to_play)

    return [arrays(gh) for gh in games], [arrays(gh) for gh in evals], steps


# ---- rank functions (run in the launched processes; no JAX) ---------------

def _step_case(name, mesh, inputs, fused=False):
    cfg = CONFIGS[name]()
    learner = Learner(cfg, device="cpu", seed=0)
    batch = {k[len(name) + 1:]: v for k, v in inputs.items() if k.startswith(name + "/")}
    if fused:
        metrics, priorities = make_sharded_fused_train_steps(learner, mesh)(
            shard_stacked_batches(batch, mesh))
    else:
        metrics, priorities = make_sharded_train_step(learner, mesh)(shard_batch(batch, mesh))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "priorities": priorities.numpy(),
            "state": {k: v.numpy().copy() for k, v in learner.full_state_dict().items()},
            "local": {k: v.detach().numpy().copy() for k, v in learner.network.state_dict().items()}}


def _sweep_case(mesh):
    """The reanalyse sweep split over dp against the unsharded sweep (rank 0
    holds the replay)."""
    from muzero_general_tpu_torch import MuZero

    overrides = dict(reanalyse_games_per_interval=4, reanalyse_chunk_positions=6)
    mz = MuZero("cartpole", overrides, device="cpu")
    learner = Learner(mz.config, device="cpu", seed=0)
    make_sharded_train_step(learner, mesh)

    def replay():
        buf = ReplayBuffer(mz.config)
        rng = np.random.default_rng(0)
        for length in (5, 7, 3):
            buf.save_game(GameHistory(
                observations=rng.normal(size=(length, 1, 1, 4)).astype(np.float32),
                actions=np.zeros(length + 1, np.int32),
                rewards=np.ones(length + 1, np.float32),
                to_play=np.zeros(length + 1, np.int32),
                child_visits=np.full((length, 2), 0.5, np.float32),
                root_values=np.zeros(length, np.float32)))
        return buf

    sharded = replay()
    n = mz._reanalyse_sweep_mesh(sharded, learner, mesh)
    if mesh.rank:
        return None
    plain = replay()
    assert mz._reanalyse_sweep(plain, learner.network) == n == 3
    return [(sharded.buffer[g].reanalysed_predicted_root_values,
             plain.buffer[g].reanalysed_predicted_root_values) for g in range(3)]


def bn_inputs():
    """A global [8, 3, 4, 4] batch for the global batch norm and the
    gradient fed back into its output: channel 0 ordinary, channels 1 and 2
    of a mean that dwarfs their spread (100 + 0.01 N(0, 1) and
    -50 + 0.1 N(0, 1)), where E[x^2] - E[x]^2 in float32 cancels below
    zero."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, 3, 4, 4)) * np.array([1.0, 0.01, 0.1])[:, None, None]
    x += np.array([0.0, 100.0, -50.0])[:, None, None]
    return x.astype(np.float32), rng.normal(size=(8, 3, 4, 4)).astype(np.float32)


def batch_norm_case(x, g, dp_group=None):
    """A train-mode batch norm (flax's) on `x`, then the backward of
    (out * g).sum(): out, x's gradient, scale's and bias's gradients and the
    running statistics."""
    from muzero_general_tpu_torch.models.common import batch_norm

    bn = batch_norm(3)
    bn.dp_group = dp_group
    x = torch.from_numpy(x).requires_grad_()
    out = bn(x)
    (out * torch.from_numpy(g)).sum().backward()
    return {"out": out.detach().numpy(), "x_grad": x.grad.numpy(),
            "weight_grad": bn.weight.grad.numpy(), "bias_grad": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy()}


def ranks_dp2(inputs_path):
    """Every dp = 2 case, on one rank of a 2-rank launch."""
    inputs = dict(np.load(inputs_path))
    mesh = create_mesh(2, 1)
    out = {name: _step_case(name, mesh, inputs, fused=name == "fused") for name in CONFIGS}
    out["selfplay"] = play_games(cartpole_driver(4, mesh), SP_MOVES)
    out["selfplay_odd"] = play_games(cartpole_driver(3, mesh), SP_MOVES)
    out["host"] = play_games(lunarlander_driver(4, mesh), 8, host=True)
    out["sweep"] = _sweep_case(mesh)
    rows = slice(4 * mesh.rank, 4 * mesh.rank + 4)
    out["batch_norm"] = batch_norm_case(*(a[rows] for a in bn_inputs()), mesh.dp_group)
    out["global_sum"] = dist_lib.global_sum(mesh.rank + 1.5)
    local = dist_lib.process_local_batch({"x": np.full((2, 3), mesh.rank)}, mesh)["x"]
    out["local_batch"] = (str(local.device), local.numpy())
    return out


def ranks_dp2mp2(inputs_path):
    inputs = dict(np.load(inputs_path))
    mesh = create_mesh(2, 2)
    return {"fc": _step_case("fc", mesh, inputs), "position": (mesh.dp_index, mesh.mp_index)}


# ---- the JAX side and the launches ----------------------------------------

def jax_steps(name, batch, mesh_shape=None, fused=False):
    """JAX's step on `batch` from the port's seeded init: single-device, or
    sharded on a (dp, mp) mesh of the virtual CPU devices. Returns
    (metrics, priorities [B, U+1] or [M, B, U+1], params before, after,
    batch_stats after)."""
    import jax
    import jax.numpy as jnp

    from muzero_general_tpu.config import MuZeroConfig as JaxConfig
    from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
    from muzero_general_tpu.parallel import (
        create_mesh as jax_mesh,
        make_sharded_fused_train_steps as jax_sharded_fused,
        make_sharded_train_step as jax_sharded,
        shard_batch as jax_shard_batch,
        shard_stacked_batches as jax_shard_stacked,
        shard_train_state,
    )
    from muzero_general_tpu.trainer import (
        TrainState,
        make_fused_train_steps,
        make_optimizer,
        make_train_step,
    )

    jcfg = CONFIGS[name](JaxConfig)
    runner = JaxNetwork(jcfg)
    variables = jax.tree_util.tree_map(
        jnp.asarray, params_to_jax(Learner(CONFIGS[name](), device="cpu", seed=0).network))
    before = dict(_flat(jax.device_get(variables["params"])))
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=make_optimizer(jcfg).init(variables["params"]),
                       step=jnp.int32(0))
    if mesh_shape is None:
        make = make_fused_train_steps if fused else make_train_step
        out = make(runner, jcfg, donate=False)(
            state, {k: jnp.asarray(v.copy()) for k, v in batch.items()})
    else:
        dp, mp = mesh_shape
        mesh = jax_mesh(num_dp=dp, num_mp=mp, devices=jax.devices()[: dp * mp])
        place = jax_shard_stacked if fused else jax_shard_batch
        make = jax_sharded_fused if fused else jax_sharded
        out = make(runner, jcfg, mesh)(shard_train_state(state, mesh), place(batch, mesh))
    new, metrics, priorities = out
    return ({k: float(v) for k, v in metrics.items()}, np.asarray(priorities), before,
            dict(_flat(jax.device_get(new.params))), dict(_flat(jax.device_get(new.batch_stats))))


def _inputs(tmp_path):
    inputs = {}
    for name in CONFIGS:
        cfg = CONFIGS[name]()
        if name == "fused":
            parts = [fake_batch(cfg, 10 + i) for i in range(2)]
            batch = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
        else:
            batch = fake_batch(cfg, 3)
        inputs.update({f"{name}/{k}": v for k, v in batch.items()})
    path = tmp_path / "inputs.npz"
    np.savez(path, **inputs)
    return path, inputs


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    path, inputs = _inputs(tmp_path_factory.mktemp("dp2"))
    return inputs, dist_lib.launch(ranks_dp2, ["cpu", "cpu"], str(path))


@pytest.fixture(scope="module")
def dp2mp2(tmp_path_factory):
    path, inputs = _inputs(tmp_path_factory.mktemp("dp2mp2"))
    return inputs, dist_lib.launch(ranks_dp2mp2, ["cpu"] * 4, str(path))


def _batch(inputs, name):
    return {k[len(name) + 1:]: v for k, v in inputs.items() if k.startswith(name + "/")}


def _port_params(state):
    return dict(_flat(params_to_jax({k: torch.from_numpy(v) for k, v in state.items()})["params"]))


def _port_stats(state):
    return dict(_flat(params_to_jax(
        {k: torch.from_numpy(v) for k, v in state.items()})["batch_stats"]))


def _global_priorities(results, mp, axis=0):
    return np.concatenate([r["priorities"] for r in results[::mp]], axis=axis)


# ---- tests ------------------------------------------------------------------

def test_param_sharding_rule_matches_jax():
    import jax

    from muzero_general_tpu.config import MuZeroConfig as JaxConfig
    from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
    from muzero_general_tpu.parallel import create_mesh as jax_mesh
    from muzero_general_tpu.parallel import param_sharding as jax_param_sharding

    mesh = create_mesh(num_dp=4, num_mp=2, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "mp": 2} and mesh.dp_group is None
    net = MuZeroNetwork(big_fc_config(), device="cpu")
    sharded = {name for name, s in param_sharding(net, mesh).items() if s.spec == ("mp",)}
    assert sharded  # the 512-wide layers
    for name in sharded:
        assert dict(net.named_parameters())[name].shape[0] == 512
    # The rule reads shapes only: JAX's params as shapes, not computed.
    shapes = jax.eval_shape(JaxNetwork(big_fc_config(JaxConfig)).init, jax.random.PRNGKey(0))
    jax_shardings = jax_param_sharding(shapes["params"], jax_mesh(num_dp=4, num_mp=2))
    jax_sharded = {".".join(str(k.key) for k in path)
                   for path, s in jax.tree_util.tree_leaves_with_path(jax_shardings)
                   if "mp" in str(s.spec)}
    # A JAX kernel leaf is the port's weight; the port shards its bias too.
    assert {n[: -len(".kernel")] for n in jax_sharded} == {
        n.rsplit(".", 1)[0] for n in sharded}
    assert {n for n in sharded if n.endswith(".weight")} == {
        n[: -len(".kernel")] + ".weight" for n in jax_sharded}


@pytest.mark.parametrize("mesh_dp,mesh_mp,devices", [
    (None, 1, 1), (1, 1, 4), (None, 2, 8), (2, 1, 4), (4, 2, 8), (2, 2, 3), (3, 1, 2)])
def test_mesh_from_config_sizes_match_jax(mesh_dp, mesh_mp, devices):
    import jax

    from muzero_general_tpu.config import MuZeroConfig as JaxConfig
    from muzero_general_tpu.parallel import mesh_from_config as jax_mesh_from_config

    results = []
    for cls, fleet in ((JaxConfig, jax.devices()[:devices]), (MuZeroConfig, ["cpu"] * devices)):
        cfg = cls()
        cfg.mesh_dp, cfg.mesh_mp = mesh_dp, mesh_mp
        try:
            mesh = (jax_mesh_from_config if cls is JaxConfig else mesh_from_config)(cfg, fleet)
            results.append(None if mesh is None else dict(mesh.shape))
        except ValueError as err:
            results.append(str(err))
    assert results[0] == results[1]


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)], ids=["dp2", "dp2mp2"])
def test_fc_sharded_step_matches_jax(mesh_shape, dp2, dp2mp2):
    inputs, results = dp2 if mesh_shape == (2, 1) else dp2mp2
    results = [r["fc"] for r in results]
    batch = _batch(inputs, "fc")
    single = jax_steps("fc", batch)
    sharded = jax_steps("fc", batch, mesh_shape)
    got_priorities = _global_priorities(results, mesh_shape[1])
    for want in (single, sharded):
        metrics, priorities, before, after, _ = want
        for r in results:
            assert r["metrics"]["total_loss"] == pytest.approx(metrics["total_loss"], rel=LOSS_REL)
        np.testing.assert_allclose(got_priorities, priorities, rtol=PRIO_RTOL, atol=PRIO_ATOL)
        got = _port_params(results[0]["state"])
        assert got.keys() == after.keys()
        for name in after:
            np.testing.assert_allclose(got[name] - before[name], after[name] - before[name],
                                       rtol=UPDATE_RTOL, atol=UPDATE_ATOL, err_msg=name)


def test_mp_layers_hold_their_slices(dp2mp2):
    """At mp 2 each rank holds half of every 512-wide layer (its mp index's
    half), and the gathered state is whole."""
    _, results = dp2mp2
    for r in results:
        dp_index, mp_index = r["position"]
        local, full = r["fc"]["local"], r["fc"]["state"]
        halves = [n for n in local if local[n].shape != full[n].shape]
        assert halves and all(full[n].shape[0] == 512 for n in halves)
        for n in halves:
            np.testing.assert_array_equal(local[n], full[n][256 * mp_index: 256 * (mp_index + 1)])


def test_resnet_global_batch_norm_step_matches_jax(dp2):
    inputs, results = dp2
    metrics, priorities, _, after, stats = jax_steps("resnet", _batch(inputs, "resnet"))
    results = [r["resnet"] for r in results]
    for key in ("total_loss", "value_loss", "reward_loss", "policy_loss"):
        np.testing.assert_allclose(results[0]["metrics"][key], metrics[key], rtol=T_LOSS_RTOL,
                                   atol=T_LOSS_ATOL, err_msg=key)
    np.testing.assert_allclose(_global_priorities(results, 1), priorities, rtol=PRIO_RTOL,
                               atol=PRIO_ATOL)
    got = _port_params(results[0]["state"])
    for name in after:
        np.testing.assert_allclose(got[name], after[name], atol=T_PARAM_ATOL, err_msg=name)
    got = _port_stats(results[0]["state"])
    assert got.keys() == stats.keys()
    for name in stats:  # the running statistics of the whole batch, not a shard's
        np.testing.assert_allclose(got[name], stats[name], rtol=STATS_RTOL, atol=STATS_ATOL,
                                   err_msg=name)


# The global batch norm against one rank's on the whole batch. x near 100
# is quantised in float32 to 7.6e-6, 7.6e-4 of channel 1's spread, so the
# two means may differ by that much of it; E[x^2] - E[x]^2 would be off by
# ~1e-3 on a variance of 1e-4 there (or below zero, and NaN).
BN_OUT_ATOL, BN_GRAD_RTOL, BN_STATS_ATOL = 5e-3, 5e-3, 1e-6


def test_global_batch_norm_stable_where_mean_dwarfs_spread(dp2):
    _, results = dp2
    got = [r["batch_norm"] for r in results]
    want = batch_norm_case(*bn_inputs())
    for key in ("out", "x_grad"):
        value = np.concatenate([r[key] for r in got])
        assert np.isfinite(value).all(), key
        scale = 1.0 if key == "out" else np.abs(want[key]).max()
        np.testing.assert_allclose(value, want[key], rtol=0, atol=BN_OUT_ATOL * scale,
                                   err_msg=key)
    for key in ("weight_grad", "bias_grad"):  # each rank's share, summed
        np.testing.assert_allclose(sum(r[key] for r in got), want[key], rtol=BN_GRAD_RTOL,
                                   atol=BN_GRAD_RTOL, err_msg=key)
    for key in ("running_mean", "running_var"):
        for r in got:
            np.testing.assert_allclose(r[key], want[key], rtol=0, atol=BN_STATS_ATOL,
                                       err_msg=key)


def test_fused_sharded_steps_match_jax(dp2):
    inputs, results = dp2
    metrics, priorities, _, after, _ = jax_steps("fused", _batch(inputs, "fused"), fused=True)
    results = [r["fused"] for r in results]
    assert results[0]["priorities"].shape == (2, 4, 4)  # [M, B / dp, U + 1]
    np.testing.assert_allclose(results[0]["metrics"]["total_loss"], metrics["total_loss"],
                               rtol=T_LOSS_RTOL, atol=T_LOSS_ATOL)
    np.testing.assert_allclose(_global_priorities(results, 1, axis=1), priorities,
                               rtol=PRIO_RTOL, atol=PRIO_ATOL)
    got = _port_params(results[0]["state"])
    for name in after:
        np.testing.assert_allclose(got[name], after[name], atol=T_PARAM_ATOL, err_msg=name)


def test_ranks_agree_bit_for_bit(dp2, dp2mp2):
    """After the steps the replicated parameters (and the gathered mp ones)
    are bit-identical on every rank, as are the loss metrics."""
    for _, results in (dp2, dp2mp2):
        for case in ("fc", "resnet", "fused"):
            if case not in results[0]:
                continue
            first = results[0][case]
            for r in results[1:]:
                assert r[case]["metrics"] == first["metrics"]
                for name, value in first["state"].items():
                    np.testing.assert_array_equal(r[case]["state"][name], value, err_msg=name)


def _assert_same_games(got, want):
    """Observations, actions, rewards, visit policies and players exact; the
    root values (the network at another batch size, whose float32 products
    the CPU may block otherwise) within ROOT_VALUE_ATOL."""
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        for field, (a, b) in enumerate(zip(g, w)):
            if field == 4:
                np.testing.assert_allclose(a, b, rtol=0, atol=ROOT_VALUE_ATOL)
            else:
                np.testing.assert_array_equal(a, b)


def test_sharded_selfplay_equals_unsharded(dp2):
    """Rank 0 of the dp = 2 driver returns the unsharded driver's games and
    eval games, lane for lane; rank 1 returns none."""
    _, results = dp2
    games, evals, steps = results[0]["selfplay"]
    want_games, want_evals, want_steps = play_games(cartpole_driver(4), SP_MOVES)
    _assert_same_games(games, want_games)
    _assert_same_games(evals, want_evals)
    assert steps == want_steps == 4 * SP_MOVES
    assert results[1]["selfplay"][:2] == ([], [])
    # The lanes did not all play one game: their start states differ.
    assert len({g[0][0].tobytes() for g in games}) > 1


def test_sharded_selfplay_indivisible_runs_unsharded(dp2):
    _, results = dp2
    games, evals, steps = results[0]["selfplay_odd"]
    want_games, want_evals, want_steps = play_games(cartpole_driver(3), SP_MOVES)
    _assert_same_games(games, want_games)
    _assert_same_games(evals, want_evals)
    assert steps == want_steps == 3 * SP_MOVES
    assert results[1]["selfplay_odd"] == ([], [], 0)


def test_sharded_host_driver_equals_unsharded(dp2):
    _, results = dp2
    games, evals, steps = results[0]["host"]
    want_games, want_evals, want_steps = play_games(lunarlander_driver(4), 8, host=True)
    _assert_same_games(games, want_games)
    _assert_same_games(evals, want_evals)
    assert steps == want_steps == 32
    assert results[1]["host"][:2] == ([], [])


def test_sweep_split_over_dp_equals_unsharded(dp2):
    _, results = dp2
    assert results[1]["sweep"] is None
    for sharded, plain in results[0]["sweep"]:
        np.testing.assert_array_equal(sharded, plain)


def test_global_sum_and_process_local_batch(dp2):
    _, results = dp2
    assert [r["global_sum"] for r in results] == [4.0, 4.0]
    for rank, r in enumerate(results):
        where, rows = r["local_batch"]
        assert where == "cpu" and (rows == rank).all() and rows.shape == (2, 3)


MESH_E2E = {  # test_sharding.py:107-135's overrides
    "training_steps": 12, "parallel_games": 16, "selfplay_chunk_moves": 4,
    "num_simulations": 6, "batch_size": 16, "fused_train_steps": 4, "reanalyse_interval": 4,
    "checkpoint_interval": 4, "max_moves": 20,
}


@pytest.mark.parametrize("layout", [
    {"mesh_dp": 2},
    # mp 2 at the rule's 256 features, cut to 4 steps: every collective of a
    # column-parallel layer crosses gloo, about 0.8 s a step on the CPU.
    {"mesh_dp": 1, "mesh_mp": 2, "encoding_size": 256, "fc_representation_layers": [256],
     "fc_dynamics_layers": [256], "max_moves": 8, "training_steps": 4,
     "fused_train_steps": 2, "checkpoint_interval": 2, "reanalyse_interval": 2,
     "parallel_games": 8, "batch_size": 8},
], ids=["dp2", "mp2"])
def test_mesh_train_end_to_end(tmp_path, layout):
    """MuZero(...).train() on a device group of two CPU ranks: sharded
    self-play and training, streaming greedy eval, the reanalyse sweep, with
    JAX's invariants; the checkpoint, gathered whole, loads into a
    one-device network."""
    from muzero_general_tpu_torch import MuZero, checkpoint
    from muzero_general_tpu_torch.models import params_from_jax

    overrides = dict(MESH_E2E, results_path=str(tmp_path), **layout)
    steps = overrides["training_steps"]
    mz = MuZero("cartpole", overrides, devices=["cpu", "cpu"])
    assert mz.device == torch.device("cpu") and len(mz._devices) == 2
    ckpt = mz.train(log_in_tensorboard=False)
    assert ckpt["training_step"] == steps
    assert ckpt["num_played_games"] > 0
    assert ckpt["episode_length"] > 0
    assert ckpt["num_reanalysed_games"] >= ckpt["num_played_games"]
    assert np.isfinite(ckpt["total_loss"])
    saved = checkpoint.load_checkpoint(tmp_path / "model.checkpoint")
    assert saved["training_step"] == steps
    # Whole arrays, in the layout JAX's network of the same config takes.
    import jax

    from muzero_general_tpu.config import load_game_module as jax_game
    from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork

    jcfg = jax_game("cartpole").MuZeroConfig()
    for key, value in layout.items():
        setattr(jcfg, key, value)
    shapes = jax.eval_shape(JaxNetwork(jcfg).init, jax.random.PRNGKey(0))["params"]
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), shapes) == jax.tree_util.tree_map(
        np.shape, saved["weights"]["params"])
    net = MuZeroNetwork(mz.config, device="cpu")
    net.load_state_dict(params_from_jax(saved["weights"]))
    assert set(mz.phase_time) >= {"selfplay", "train"}
    assert torch.equal(functools.reduce(torch.add, [p.sum()[None] for p in net.parameters()]),
                       functools.reduce(torch.add, [p.sum()[None] for p in mz.network.parameters()]))
