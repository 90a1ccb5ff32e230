"""The port's learner (muzero_general_tpu_torch/trainer.py) against the JAX
package's make_train_step / make_fused_train_steps.

Both sides start from the same variables (the port's seeded init, carried
to the JAX side with params_to_jax) and take the same numpy batches, drawn from
np.random.default_rng(seed): the FC net of tests/test_trainer.py and a
1-block, 8-channel ResNet at tictactoe size, batch 4, unroll 3. After one
step, or one fused 8-step call, the losses, priorities, params, optimizer
state and batch_stats must agree within these tolerances (float32 math
summed in another order, through up to 8 Adam updates):
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.config import MuZeroConfig as JaxConfig
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.trainer import (
    TrainState,
    lr_schedule as jax_lr_schedule,
    make_fused_train_steps,
    make_optimizer,
    make_train_step,
    scale_gradient as jax_scale_gradient,
)
from muzero_general_tpu_torch.checkpoint import optimizer_state_to_jax
from muzero_general_tpu_torch.config import MuZeroConfig
from muzero_general_tpu_torch.models import params_to_jax
from muzero_general_tpu_torch.trainer import (
    Learner,
    cross_entropy,
    lr_schedule,
    scale_gradient,
)

LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-5  # losses, f32 (observed <= 3.1e-6 relative)
# priorities: rtol 1e-4 (after 8 steps, the decode h^-1 amplifies the
# params' differences: observed 2.1e-5 relative), atol 1e-5
PRIO_RTOL, PRIO_ATOL = 1e-4, 1e-5
PARAM_ATOL = 1e-5  # params after up to 8 SGD steps
# Adam: 1% of the largest move lr * steps. An element whose gradient is near
# eps moves by lr * g / (|g| + eps), which magnifies the gradient's rounding
# (observed 4.0e-5 after one step at lr 0.02, 0.2%); gradients themselves
# are held tight in test_gradients_match_jax.
ADAM_PARAM_TOL = 1e-2
# batch_stats: flax takes the variance as E[x^2] - E[x]^2, torch in two
# passes, so running variances ~2 differ by up to ~4e-5.
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5
# Adam mu, nu and SGD trace: within 1e-4 of the tree's largest magnitude
# (a moment summed from cancelling gradients keeps their absolute error).
MOMENT_TOL = 1e-4
# Gradients, through SGD at lr 1: rtol 1e-5, and an absolute 1e-5 of the
# leaf's largest gradient (batch norm's backward subtracts means, which
# keeps the absolute error of the large terms; observed <= 2.8e-7 on 0.1).
GRAD_RTOL, GRAD_SCALE_TOL = 1e-5, 1e-5
# bfloat16 products: each framework rounds its own bf16 partial results, so
# losses agree to ~1%, priorities (|value - target| ** 0.5, whose slope
# grows near 0) to 0.1, and params, after SGD steps (Adam's first steps are
# lr * sign(g), which a tiny gradient can flip), to a fraction of an update.
BF16_LOSS_RTOL, BF16_PRIO_ATOL, BF16_PARAM_ATOL = 2e-2, 1e-1, 2e-3


def small_config(cls, network="fullyconnected", **kw):
    c = cls()
    c.observation_shape = (1, 1, 4)
    c.action_space = list(range(2))
    c.encoding_size = 4
    c.fc_dynamics_layers = [8]
    c.fc_reward_layers = [8]
    c.fc_value_layers = [8]
    c.fc_policy_layers = [8]
    c.support_size = 5
    c.num_unroll_steps = 3
    c.batch_size = 4
    if network == "resnet":
        c.network = "resnet"
        c.observation_shape = (3, 3, 3)
        c.action_space = list(range(9))
        c.blocks = 1
        c.channels = 8
        c.reduced_channels_reward = 2
        c.reduced_channels_value = 2
        c.reduced_channels_policy = 2
        c.resnet_fc_reward_layers = [8]
        c.resnet_fc_value_layers = [8]
        c.resnet_fc_policy_layers = [8]
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def fake_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    B, U = cfg.batch_size, cfg.num_unroll_steps
    A = len(cfg.action_space)
    c, h, w = cfg.observation_shape
    n = cfg.stacked_observations
    return {
        "observation": rng.normal(size=(B, c * (n + 1) + n, h, w)).astype(np.float32),
        "action": rng.integers(0, A, (B, U + 1)).astype(np.int32),
        "target_value": (5 * rng.normal(size=(B, U + 1))).astype(np.float32),
        "target_reward": rng.normal(size=(B, U + 1)).astype(np.float32),
        "target_policy": rng.dirichlet(np.ones(A), (B, U + 1)).astype(np.float32),
        "weight": rng.uniform(0.2, 1.0, B).astype(np.float32),
        "gradient_scale": rng.integers(1, U + 1, (B, U + 1)).astype(np.float32),
    }


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield prefix + key, np.asarray(value)


def assert_trees_close(got, want, atol, rtol=0.0, what=""):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), what
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def setup(network, **kw):
    """A port learner on the CPU (seeded init) and the JAX train state from
    the same variables, carried over with params_to_jax."""
    jcfg = small_config(JaxConfig, network, **kw)
    learner = Learner(small_config(MuZeroConfig, network, **kw), device="cpu", seed=0)
    variables = jax.tree_util.tree_map(jnp.asarray, params_to_jax(learner.network))
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=make_optimizer(jcfg).init(variables["params"]),
                       step=jnp.int32(0))
    return jcfg, JaxNetwork(jcfg), state, learner


def run_both(network, steps, seed=0, **kw):
    """One step (steps=1) or one fused call of `steps` batches on each side.
    Returns (JAX state, JAX metrics, JAX priorities, learner, port metrics,
    port priorities), the priorities [steps, B, U+1]."""
    jcfg, runner, state, learner = setup(network, **kw)
    batches = [fake_batch(jcfg, seed + i) for i in range(steps)]
    if steps == 1:
        fn = make_train_step(runner, jcfg, donate=False)
        jstate, jm, jp = fn(state, {k: jnp.asarray(v.copy()) for k, v in batches[0].items()})
        jp = np.asarray(jp)[None]
        tm, tp = learner.train_step(batches[0])
        tp = tp[None]
    else:
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        fn = make_fused_train_steps(runner, jcfg, donate=False)
        jstate, jm, jp = fn(state, {k: jnp.asarray(v.copy()) for k, v in stacked.items()})
        jp = np.asarray(jp)
        tm, tp = learner.train_steps(stacked)
    return jstate, jm, jp, learner, tm, tp.numpy()


def assert_moments_close(got, want, what):
    atol = MOMENT_TOL * max(np.abs(x).max() for _, x in _leaves(want))
    assert_trees_close(got, want, atol, what=what)


def check_optimizer_state(jstate, learner):
    got = optimizer_state_to_jax(learner)
    _, inner, schedule = jstate.opt_state
    assert int(got["schedule_count"]) == int(schedule.count) == learner.training_step
    if learner.config.optimizer == "Adam":
        assert int(got["count"]) == int(inner.count)
        for key, want in (("mu", inner.mu), ("nu", inner.nu)):
            assert_moments_close(got[key], want, key)
    else:
        assert_moments_close(got["trace"], inner.trace, "trace")


# Each network with each optimizer, PER on and off, a single step and a
# fused 8-step call, in 8 cases.
CASES = [
    ("fullyconnected", "Adam", True, 1),
    ("fullyconnected", "Adam", False, 8),
    ("fullyconnected", "SGD", True, 8),
    ("fullyconnected", "SGD", False, 1),
    ("resnet", "Adam", True, 8),
    ("resnet", "Adam", False, 1),
    ("resnet", "SGD", True, 1),
    ("resnet", "SGD", False, 8),
]


@pytest.mark.parametrize("network,optimizer,per,steps", CASES)
def test_train_step_matches_jax(network, optimizer, per, steps):
    jstate, jm, jp, learner, tm, tp = run_both(network, steps, optimizer=optimizer, PER=per)
    for key in ("total_loss", "value_loss", "reward_loss", "policy_loss", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=key)
    np.testing.assert_allclose(tp, jp, rtol=PRIO_RTOL, atol=PRIO_ATOL)
    got = params_to_jax(learner.network)
    atol = ADAM_PARAM_TOL * learner.config.lr_init * steps if optimizer == "Adam" else PARAM_ATOL
    assert_trees_close(got["params"], jstate.params, atol, what="params")
    assert_trees_close(got["batch_stats"], jstate.batch_stats, STATS_ATOL, STATS_RTOL,
                       what="batch_stats")
    assert learner.training_step == int(jstate.step) == steps
    check_optimizer_state(jstate, learner)


@pytest.mark.parametrize("network,steps", [("fullyconnected", 8), ("resnet", 1)])
def test_bfloat16_train_step_matches_jax(network, steps):
    jstate, jm, jp, learner, tm, tp = run_both(network, steps, compute_dtype="bfloat16",
                                               optimizer="SGD")
    for key in ("total_loss", "value_loss", "reward_loss", "policy_loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=BF16_LOSS_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=BF16_PRIO_ATOL)
    got = params_to_jax(learner.network)
    assert_trees_close(got["params"], jstate.params, BF16_PARAM_ATOL, what="params")
    assert_trees_close(got["batch_stats"], jstate.batch_stats, BF16_PARAM_ATOL,
                       what="batch_stats")
    for p in learner.network.parameters():
        assert p.dtype == torch.float32
    for s in learner.optimizer.state.values():
        assert s["momentum_buffer"].dtype == torch.float32


@pytest.mark.parametrize("network", ["fullyconnected", "resnet"])
def test_gradients_match_jax(network):
    """SGD at lr 1 with no momentum and no decay: params_before -
    params_after is the gradient itself, held tight."""
    kw = dict(optimizer="SGD", lr_init=1.0, lr_decay_rate=1.0, momentum=0.0,
              weight_decay=0.0, PER=True)
    jcfg, runner, state, learner = setup(network, **kw)
    before = params_to_jax(learner.network)["params"]
    batch = fake_batch(jcfg, 5)
    jstate, _, _ = make_train_step(runner, jcfg, donate=False)(
        state, {k: jnp.asarray(v.copy()) for k, v in batch.items()})
    learner.train_step(batch)
    after = dict(_leaves(params_to_jax(learner.network)["params"]))
    jax_after = dict(_leaves(jstate.params))
    for name, p0 in _leaves(before):
        want = p0 - jax_after[name]
        np.testing.assert_allclose(p0 - after[name], want, rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE_TOL * np.abs(want).max(), err_msg=name)


def test_scale_gradient_and_cross_entropy_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    s = rng.uniform(0.1, 1.0, (4, 1)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)

    def jax_f(x):
        return jnp.sum(jax_scale_gradient(x, jnp.asarray(s)) ** 2 * w)

    xt = torch.from_numpy(x.copy()).requires_grad_()
    y = scale_gradient(xt, torch.from_numpy(s))
    # forward identity, up to the rounding of x * s + x * (1 - s)
    np.testing.assert_allclose(y.detach().numpy(), x, rtol=1e-6)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jax_scale_gradient(x, s)),
                               rtol=1e-6)
    (y ** 2 * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax.grad(jax_f)(x)), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), 2 * x * w * s, rtol=1e-6)

    from muzero_general_tpu.trainer import cross_entropy as jax_cross_entropy

    target = rng.dirichlet(np.ones(6), 4).astype(np.float32)
    np.testing.assert_allclose(
        cross_entropy(torch.from_numpy(x), torch.from_numpy(target)).numpy(),
        np.asarray(jax_cross_entropy(x, target)), rtol=1e-6)


def test_lr_schedule_matches_jax():
    cfg = small_config(MuZeroConfig, lr_init=0.02, lr_decay_rate=0.8, lr_decay_steps=1000)
    jax_schedule = jax_lr_schedule(small_config(
        JaxConfig, lr_init=0.02, lr_decay_rate=0.8, lr_decay_steps=1000))
    schedule = lr_schedule(cfg)
    steps = [0, 1, 999, 1000, 2500]
    for step in steps:
        assert schedule(step) == pytest.approx(float(jax_schedule(step)), rel=1e-6)
    # The learner's LambdaLR gives the same lr to each update, from a fresh
    # start and resumed at a count.
    learner = Learner(cfg, device="cpu")
    for step in steps:
        learner.set_schedule_count(step)
        assert learner.lr() == pytest.approx(schedule(step), rel=1e-12)
    learner.set_schedule_count(0)
    for step in range(3):
        assert learner.lr() == pytest.approx(schedule(step), rel=1e-12)
        learner.optimizer.step()
        learner.scheduler.step()


@pytest.mark.parametrize("network", ["fullyconnected", "resnet"])
def test_remat_equals_plain_unroll(network):
    """remat_unroll only trades memory: losses, priorities, gradients,
    params and the batch norms' running statistics equal the plain
    unroll's bit for bit."""
    results = []
    for remat in (True, False):
        cfg = small_config(MuZeroConfig, network, remat_unroll=remat)
        learner = Learner(cfg, device="cpu", seed=1)
        state0 = {k: v.clone() for k, v in learner.network.state_dict().items()}
        metrics, prio = learner.train_steps(
            {k: np.stack([fake_batch(cfg, i)[k] for i in range(2)])
             for k in fake_batch(cfg, 0)})
        grads = [p.grad.clone() for p in learner.network.parameters()]
        results.append((metrics, prio, grads, learner.network.state_dict(), state0))
    (m1, p1, g1, s1, a1), (m2, p2, g2, s2, a2) = results
    assert all(torch.equal(a1[k], a2[k]) for k in a1)
    for key in ("total_loss", "value_loss", "reward_loss", "policy_loss"):
        assert torch.equal(m1[key], m2[key]), key
    assert torch.equal(p1, p2)
    # The recomputed forward runs the same operations on the same values.
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
    if network == "resnet":
        # 2 steps x (representation + 4 predictions + 3 dynamics) per block
        tracked = [v for k, v in s1.items() if k.endswith("num_batches_tracked")]
        assert tracked and all(int(v) > 0 for v in tracked)
        assert int(s1["dynamics_network.BatchNorm_0.num_batches_tracked"]) == 2 * 3
        assert int(s1["prediction_network.ResidualBlock_0.BatchNorm_0.num_batches_tracked"]) \
            == 2 * 4
