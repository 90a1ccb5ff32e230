"""Checkpoint and replay-buffer persistence, and the training state's way in
and out of them (port of checkpoint.py, with muzero.py:134-160's restore
and sync).

The reference's 17-key checkpoint dict (reference muzero.py:99-117) is kept:
the same dict is the live state and the on-disk `model.checkpoint`; the
replay buffer is persisted apart as `replay_buffer.pkl` with its counters
(reference muzero.py:334-346).

- "weights" is the flax variable tree of numpy float32 arrays,
  {"params": ..., "batch_stats": ...} (`batch_stats` {} for an FC net), in
  either package: models.network params_from_jax and params_to_jax carry it
  onto and off a module.
- "optimizer_state" as the JAX package writes it holds optax state
  classes; the port does not import optax, so `load_checkpoint` gives them
  back as tuple stand-ins with the same fields:
  (EmptyState(), ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))
  for Adam, (EmptyState(), TraceState(trace), ScaleByScheduleState(count))
  for SGD. `restore_learner` maps mu/nu/count onto torch Adam's
  exp_avg/exp_avg_sq/step, trace onto SGD's momentum_buffer and the
  schedule's count onto the learner's LambdaLR, through the weights' name
  and layout mapping.
- The port writes its optimizer state as a plain dict of numpy trees in the
  flax layout: {"optimizer": "Adam", "count", "mu", "nu", "schedule_count"}
  or {"optimizer": "SGD", "trace", "schedule_count"}. The JAX package can
  load a port checkpoint's weights (and counters), but it cannot resume its
  optimizer from this dict: its restore expects optax classes.
- A JAX-written replay_buffer.pkl holds the JAX package's GameHistory;
  `load_replay_buffer` gives its games back as the port's, which has the
  same fields.
"""

import pathlib
import pickle

import numpy as np
import torch

from muzero_general_tpu_torch.models.network import params_from_jax, params_to_jax
from muzero_general_tpu_torch.parallel.mesh import gather_sharded
from muzero_general_tpu_torch.trainer import LOSS_KEYS

CHECKPOINT_KEYS = [
    "weights",
    "optimizer_state",
    "total_reward",
    "muzero_reward",
    "opponent_reward",
    "episode_length",
    "mean_value",
    "training_step",
    "lr",
    "total_loss",
    "value_loss",
    "reward_loss",
    "policy_loss",
    "num_played_games",
    "num_played_steps",
    "num_reanalysed_games",
    "terminate",
]

# The package whose (NamedTuple) state classes a JAX-written checkpoint holds
# and which the port never imports.
_FOREIGN_PACKAGE = "optax"
# The JAX package's game record, which a JAX-written replay buffer holds.
_JAX_GAME_HISTORY = ("muzero_general_tpu.replay", "GameHistory")


def initial_checkpoint() -> dict:
    """Fresh checkpoint (reference muzero.py:99-117)."""
    return {
        "weights": None,
        "optimizer_state": None,
        "total_reward": 0,
        "muzero_reward": 0,
        "opponent_reward": 0,
        "episode_length": 0,
        "mean_value": 0,
        "training_step": 0,
        "lr": 0,
        "total_loss": 0,
        "value_loss": 0,
        "reward_loss": 0,
        "policy_loss": 0,
        "num_played_games": 0,
        "num_played_steps": 0,
        "num_reanalysed_games": 0,
        "terminate": False,
    }


class _ForeignTuple(tuple):
    """Stand-in for a NamedTuple class of a package the port does not load."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".", 1)[0] == _FOREIGN_PACKAGE:
            return type(name, (_ForeignTuple,), {"__module__": module})
        if (module, name) == _JAX_GAME_HISTORY:
            # A JAX-written replay_buffer.pkl: the port's GameHistory has the
            # same fields, so its games load without the JAX package.
            from muzero_general_tpu_torch.replay import GameHistory

            return GameHistory
        return super().find_class(module, name)


def save_checkpoint(checkpoint: dict, path):
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(checkpoint, f)


def load_checkpoint(path) -> dict:
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def save_replay_buffer(replay_buffer, checkpoint: dict, path):
    """Persist buffer + counters (reference muzero.py:334-346)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(
            {
                "buffer": replay_buffer.buffer,
                "num_played_games": checkpoint["num_played_games"],
                "num_played_steps": checkpoint["num_played_steps"],
                "num_reanalysed_games": checkpoint["num_reanalysed_games"],
            },
            f,
        )


def load_replay_buffer(path) -> dict:
    """A replay_buffer.pkl written by either package."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


# ---------------------------------------------------------------------------
# The optimizer state in the flax layout
# ---------------------------------------------------------------------------


def _per_param(learner, key):
    """{parameter name: the optimizer's `key` tensor} (zeros before the
    first update), mp-sharded moments gathered whole on a mesh."""
    state = learner.optimizer.state
    return gather_sharded({
        name: state[p][key] if key in state.get(p, {}) else torch.zeros_like(p)
        for name, p in learner.network.named_parameters()
    }, learner)


def optimizer_state_to_jax(learner) -> dict:
    """The learner's optimizer and schedule state as a dict of numpy trees
    in the flax layout (see the module docstring)."""
    out = {"optimizer": learner.config.optimizer,
           "schedule_count": np.int32(learner.scheduler.last_epoch)}
    if learner.config.optimizer == "Adam":
        steps = [s["step"] for s in learner.optimizer.state.values() if "step" in s]
        out["count"] = np.int32(int(steps[0]) if steps else 0)
        out["mu"] = params_to_jax(_per_param(learner, "exp_avg"))["params"]
        out["nu"] = params_to_jax(_per_param(learner, "exp_avg_sq"))["params"]
    else:
        out["trace"] = params_to_jax(_per_param(learner, "momentum_buffer"))["params"]
    return out


def _from_flax(learner, tree) -> dict:
    """{parameter: tensor on the learner's device} from a params tree."""
    state = params_from_jax({"params": tree})
    return {p: state[name].to(learner.device)
            for name, p in learner.network.named_parameters()}


def load_optimizer_state(learner, state):
    """Load a JAX-written (optax stand-ins) or port-written optimizer state
    into the learner's optimizer and schedule."""
    if isinstance(state, dict):
        if state["optimizer"] != learner.config.optimizer:
            raise ValueError(f"checkpoint optimizer {state['optimizer']!r}, "
                             f"config {learner.config.optimizer!r}")
        fields, schedule_count = state, state["schedule_count"]
    else:
        fields = {}
        for part in state:
            kind = type(part).__name__
            if kind == "ScaleByAdamState":
                fields["optimizer"] = "Adam"
                fields["count"], fields["mu"], fields["nu"] = part
            elif kind == "TraceState":
                fields["optimizer"] = "SGD"
                (fields["trace"],) = part
            elif kind == "ScaleByScheduleState":
                (schedule_count,) = part
        if fields.get("optimizer") != learner.config.optimizer:
            raise ValueError(f"checkpoint optimizer state {[type(p).__name__ for p in state]} "
                             f"does not match config {learner.config.optimizer!r}")
    opt_state = learner.optimizer.state
    opt_state.clear()
    if learner.config.optimizer == "Adam":
        step = torch.tensor(float(fields["count"]), dtype=torch.float32)
        mu, nu = _from_flax(learner, fields["mu"]), _from_flax(learner, fields["nu"])
        for p in mu:
            opt_state[p] = {"step": step.clone(), "exp_avg": mu[p], "exp_avg_sq": nu[p]}
    else:
        for p, trace in _from_flax(learner, fields["trace"]).items():
            opt_state[p] = {"momentum_buffer": trace}
    learner.set_schedule_count(int(schedule_count))


def restore_learner(learner, checkpoint: dict):
    """Resume a learner from a checkpoint dict (JAX muzero.py:134-153): the
    weights, the optimizer state if there is one, and training_step."""
    learner.network.load_state_dict(params_from_jax(checkpoint["weights"]))
    if checkpoint["optimizer_state"] is not None:
        load_optimizer_state(learner, checkpoint["optimizer_state"])
    learner.training_step = int(checkpoint["training_step"])


def sync_state(checkpoint: dict, learner, replay):
    """Write the learner's weights and optimizer state and the played
    counters into the checkpoint dict (JAX muzero.py:155-160 _sync_checkpoint).
    On a mesh with mp > 1 the weights and moments are gathered whole, so
    every rank of the mesh must call it.
    The losses stay as they are: the final persist (muzero.py:740-742) writes
    only these."""
    checkpoint["weights"] = params_to_jax(learner.full_state_dict())
    checkpoint["optimizer_state"] = optimizer_state_to_jax(learner)
    checkpoint["num_played_games"] = replay.num_played_games
    checkpoint["num_played_steps"] = replay.num_played_steps


def sync_checkpoint(checkpoint: dict, learner, replay):
    """The checkpoint-interval sync (JAX muzero.py:676-685): the last
    step's losses and lr, training_step, then `sync_state`."""
    if learner.metrics is not None:
        for key in LOSS_KEYS:
            checkpoint[key] = float(learner.metrics[key])
        checkpoint["lr"] = float(learner.metrics["lr"])
    checkpoint["training_step"] = learner.training_step
    sync_state(checkpoint, learner, replay)
