"""Checkpoint dict and loading (port of checkpoint.py:16-77, loading only).

The reference's 17-key checkpoint dict (reference muzero.py:99-117) is kept.
`load_checkpoint` reads the JAX package's `model.checkpoint` pickles, whose
"weights" are flax variable trees of numpy arrays (map them onto a module
with models.network.params_from_jax). Their "optimizer_state" holds optax
state classes; the port does not import optax, so those come back as plain
tuple stand-ins carrying the same fields' values. Saving and the replay
buffer's persistence come with the orchestrator (ROADMAP module item 10).
"""

import pickle

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
        return super().find_class(module, name)


def load_checkpoint(path) -> dict:
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()
