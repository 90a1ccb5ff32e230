"""The port's training state in and out of checkpoints
(muzero_general_tpu_torch/checkpoint.py, models/network.py params_to_jax)
and its metrics logger (logger.py), against the JAX package.

- The weight carry is exact both ways on the shipped cartpole and connect4
  checkpoints, and the JAX runner reads port-written weights.
- A port checkpoint resumes in the port bit for bit.
- A JAX checkpoint, with its Adam state, resumes in the port to the step
  the JAX package takes from the TrainState muzero.py:134-153 builds, within
  test_torch_trainer.py's tolerances.
- The replay buffer round-trips; the port's metrics.jsonl lines equal the
  JAX MetricsLogger's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu import checkpoint as jax_checkpoint
from muzero_general_tpu.games import cartpole as jax_cartpole
from muzero_general_tpu.games import connect4 as jax_connect4
from muzero_general_tpu.logger import MetricsLogger as JaxMetricsLogger
from muzero_general_tpu.models import MuZeroNetwork as JaxNetwork
from muzero_general_tpu.trainer import TrainState, make_train_step
from muzero_general_tpu_torch import checkpoint, replay
from muzero_general_tpu_torch.config import MuZeroConfig
from muzero_general_tpu_torch.games import cartpole, connect4
from muzero_general_tpu_torch.logger import SCALAR_TAGS, MetricsLogger
from muzero_general_tpu_torch.models import params_from_jax, params_to_jax
from muzero_general_tpu_torch.trainer import LOSS_KEYS, Learner
from test_torch_replay import _games
from test_torch_trainer import (
    LOSS_ATOL,
    LOSS_RTOL,
    PARAM_ATOL,
    PRIO_ATOL,
    PRIO_RTOL,
    STATS_ATOL,
    STATS_RTOL,
    assert_moments_close,
    assert_trees_close,
    fake_batch,
    small_config,
)

PRETRAINED = {"cartpole": "pretrained/cartpole/model.checkpoint",
              "connect4": "pretrained/connect4/model.checkpoint"}


def _assert_trees_equal(got, want):
    assert isinstance(got, dict) and got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_trees_equal(got[key], value)
        elif isinstance(value, str):
            assert got[key] == value, key
        else:
            assert got[key].dtype == np.asarray(value).dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("game", ["cartpole", "connect4"])
def test_params_to_jax_inverts_params_from_jax(game):
    weights = checkpoint.load_checkpoint(PRETRAINED[game])["weights"]
    _assert_trees_equal(params_to_jax(params_from_jax(weights)), weights)


@pytest.mark.parametrize("network", ["fullyconnected", "resnet"])
def test_jax_runner_reads_port_weights(network, tmp_path):
    """Weights the port trained (batch-norm statistics moved) and saved give
    the JAX runner the port's initial inference."""
    cfg = small_config(MuZeroConfig, network)
    learner = Learner(cfg, device="cpu", seed=2)
    learner.train_step(fake_batch(cfg, 0))
    ckpt = checkpoint.initial_checkpoint()
    ckpt["weights"] = params_to_jax(learner.network)
    checkpoint.save_checkpoint(ckpt, tmp_path / "model.checkpoint")
    weights = jax_checkpoint.load_checkpoint(tmp_path / "model.checkpoint")["weights"]
    assert (weights["batch_stats"] == {}) == (network == "fullyconnected")
    runner = JaxNetwork(small_config(jax_cartpole.MuZeroConfig, network))
    obs = fake_batch(cfg, 1)["observation"]
    want = runner.initial_inference(weights, jnp.asarray(obs.copy()))
    with torch.no_grad():
        got = learner.network.eval().initial_inference(torch.from_numpy(obs))
    for name, g, w in zip(("value", "reward", "policy", "hidden"), got, want):
        g = g.permute(0, 2, 3, 1) if g.ndim == 4 else g  # NCHW -> NHWC
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("network,optimizer", [("fullyconnected", "Adam"),
                                               ("resnet", "SGD")])
def test_save_load_resume_is_bit_exact(network, optimizer, tmp_path):
    cfg = small_config(MuZeroConfig, network, optimizer=optimizer)
    learner = Learner(cfg, device="cpu", seed=3)
    learner.train_steps({k: np.stack([fake_batch(cfg, i)[k] for i in range(2)])
                         for k in fake_batch(cfg, 0)})
    buffer = replay.ReplayBuffer(cfg, num_played_games=5, num_played_steps=77)
    ckpt = checkpoint.initial_checkpoint()
    checkpoint.sync_checkpoint(ckpt, learner, buffer)
    assert list(ckpt) == checkpoint.CHECKPOINT_KEYS
    assert ckpt["training_step"] == 2
    assert (ckpt["num_played_games"], ckpt["num_played_steps"]) == (5, 77)
    for key in LOSS_KEYS + ("lr",):
        assert ckpt[key] == float(learner.metrics[key])
    checkpoint.save_checkpoint(ckpt, tmp_path / "model.checkpoint")

    resumed = Learner(cfg, device="cpu", seed=4)
    checkpoint.restore_learner(resumed, checkpoint.load_checkpoint(tmp_path / "model.checkpoint"))
    assert resumed.training_step == 2 and resumed.lr() == learner.lr()
    batch = fake_batch(cfg, 9)
    m1, p1 = learner.train_step(batch)
    m2, p2 = resumed.train_step(batch)
    assert torch.equal(p1, p2)
    for key in LOSS_KEYS:
        assert torch.equal(m1[key], m2[key]), key
    s1, s2 = learner.network.state_dict(), resumed.network.state_dict()
    for key in s1:
        # num_batches_tracked has no flax counterpart and no effect (batch
        # norm's momentum is fixed); the checkpoint does not carry it.
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(s1[key], s2[key]), key
    _assert_trees_equal(checkpoint.optimizer_state_to_jax(resumed),
                        checkpoint.optimizer_state_to_jax(learner))


GAMES = {
    "cartpole": (cartpole.MuZeroConfig, jax_cartpole.MuZeroConfig, dict(batch_size=16)),
    "connect4": (connect4.MuZeroConfig, jax_connect4.MuZeroConfig,
                 dict(batch_size=4, num_unroll_steps=2)),
}
# The update from JAX's own gradient: the two frameworks' Adam arithmetic on
# the same state, the gradient recovered as params before - after (which
# keeps the params' ulp: observed <= 3.6e-7).
UPDATE_ATOL = 1e-6


def _configs(game, **extra):
    port_cls, jax_cls, kw = GAMES[game]
    cfg, jcfg = port_cls(), jax_cls()
    for key, value in {**kw, **extra}.items():
        setattr(cfg, key, value)
        setattr(jcfg, key, value)
    return cfg, jcfg


def _jax_state(ckpt, opt_state):
    """The TrainState JAX muzero.py:134-153 builds from a checkpoint."""
    weights = ckpt["weights"]
    return TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, weights["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, weights.get("batch_stats", {})),
        opt_state=jax.tree_util.tree_map(
            lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, opt_state),
        step=jnp.int32(ckpt["training_step"]),
    )


def _jax_gradient(game, ckpt, batch):
    """JAX's gradient at the checkpoint's weights: params before - after
    one SGD step at lr 1 with no momentum and no decay."""
    from muzero_general_tpu.trainer import make_optimizer

    _, jcfg = _configs(game, optimizer="SGD", lr_init=1.0, lr_decay_rate=1.0,
                       momentum=0.0, weight_decay=0.0)
    params = jax.tree_util.tree_map(jnp.asarray, ckpt["weights"]["params"])
    state = _jax_state(ckpt, make_optimizer(jcfg).init(params))
    after, _, _ = make_train_step(JaxNetwork(jcfg), jcfg, donate=False)(
        state, {k: jnp.asarray(v.copy()) for k, v in batch.items()})
    return jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                  ckpt["weights"]["params"], after.params)


@pytest.mark.parametrize("game", ["cartpole", "connect4"])
def test_resume_from_jax_checkpoint_matches_jax_step(game):
    """The shipped checkpoint (Adam state at training_step 7,500 and
    100,000) resumes in the port, and its next step equals the JAX
    package's step from the TrainState muzero.py:134-153 builds: losses,
    priorities, batch_stats, counts; the update itself from JAX's own
    gradient, and for cartpole (ELU, no kinks) from the port's too. In a
    ReLU net a pre-activation within rounding of 0 can fall on the other
    side of the kink in the other framework (observed at 64 channels),
    which moves that position's gradient term by O(1); gradients
    are held tight on the small ResNet in test_torch_trainer.py."""
    cfg, jcfg = _configs(game)
    ckpt = jax_checkpoint.load_checkpoint(PRETRAINED[game])
    state = _jax_state(ckpt, ckpt["optimizer_state"])
    learner = Learner(cfg, device="cpu")
    checkpoint.restore_learner(learner, checkpoint.load_checkpoint(PRETRAINED[game]))
    assert learner.training_step == ckpt["training_step"]

    batch = fake_batch(jcfg, 0)
    jstate, jm, jp = make_train_step(JaxNetwork(jcfg), jcfg, donate=False)(
        state, {k: jnp.asarray(v.copy()) for k, v in batch.items()})
    tm, tp = learner.train_step(batch)
    for key in LOSS_KEYS + ("lr",):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=key)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=PRIO_RTOL, atol=PRIO_ATOL)
    got = params_to_jax(learner.network)
    assert_trees_close(got["batch_stats"], jstate.batch_stats, STATS_ATOL, STATS_RTOL,
                       what="batch_stats")
    _, adam, schedule = jstate.opt_state
    out = checkpoint.optimizer_state_to_jax(learner)
    assert int(out["count"]) == int(adam.count) == ckpt["training_step"] + 1
    assert int(out["schedule_count"]) == int(schedule.count)
    if game == "cartpole":
        assert_trees_close(got["params"], jstate.params, PARAM_ATOL, what="params")
        assert_moments_close(out["mu"], adam.mu, "mu")
        assert_moments_close(out["nu"], adam.nu, "nu")

    # The resumed optimizer's update from JAX's gradient equals JAX's.
    resumed = Learner(cfg, device="cpu")
    checkpoint.restore_learner(resumed, checkpoint.load_checkpoint(PRETRAINED[game]))
    grads = params_from_jax({"params": _jax_gradient(game, ckpt, batch)})
    for name, p in resumed.network.named_parameters():
        p.grad = grads[name]
    resumed.optimizer.step()
    assert_trees_close(params_to_jax(resumed.network)["params"], jstate.params, UPDATE_ATOL,
                       what="params from JAX's gradient")
    out = checkpoint.optimizer_state_to_jax(resumed)
    assert_moments_close(out["mu"], adam.mu, "mu")
    assert_moments_close(out["nu"], adam.nu, "nu")


def test_replay_buffer_round_trip(tmp_path):
    cfg = small_config(MuZeroConfig, observation_shape=(2, 3, 3), action_space=list(range(3)))
    buffer = replay.ReplayBuffer(cfg)
    for game in _games(6):
        buffer.save_game(replay.GameHistory(**game))
    ckpt = checkpoint.initial_checkpoint()
    ckpt.update(num_played_games=6, num_played_steps=99, num_reanalysed_games=3)
    checkpoint.save_replay_buffer(buffer, ckpt, tmp_path / "replay_buffer.pkl")
    saved = checkpoint.load_replay_buffer(tmp_path / "replay_buffer.pkl")
    assert (saved["num_played_games"], saved["num_played_steps"],
            saved["num_reanalysed_games"]) == (6, 99, 3)
    restored = replay.ReplayBuffer(cfg, saved["buffer"], saved["num_played_games"],
                                   saved["num_played_steps"])
    assert restored.total_samples == buffer.total_samples
    for rb in (buffer, restored):
        rb.rng = np.random.default_rng(7)
    (i1, b1), (i2, b2) = buffer.get_batch(use_native=False), restored.get_batch(use_native=False)
    np.testing.assert_array_equal(i1, i2)
    for key in b1:
        np.testing.assert_array_equal(b1[key], b2[key], err_msg=key)


def test_metrics_logger_matches_jax(tmp_path):
    cfg = small_config(MuZeroConfig)
    infos = []
    for i in range(3):
        info = checkpoint.initial_checkpoint()
        for j, (_, key) in enumerate(SCALAR_TAGS):
            info[key] = (i + 1) * (j + 0.25)
        infos.append(info)
    for cls, path in ((MetricsLogger, tmp_path / "port"), (JaxMetricsLogger, tmp_path / "jax")):
        logger = cls(path, cfg, "summary")
        for info in infos:
            logger.log(info)
        logger.close()
    port_lines = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    assert len(port_lines) == 3
    assert port_lines == (tmp_path / "jax" / "metrics.jsonl").read_text().splitlines()
    assert list((tmp_path / "port").glob("events.out.tfevents.*"))

