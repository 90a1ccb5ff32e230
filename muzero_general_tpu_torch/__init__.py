"""muzero_general_tpu_torch — the PyTorch/CUDA port of muzero_general_tpu.

A second package beside the JAX one, which stays the reference it is held
against (tests/test_torch_*.py). Module layout and names mirror the JAX
package so each module's counterpart is easy to find: config and games,
envs, the FC and ResNet networks, the batched MCTS (its hand-written CUDA
kernels in csrc/, built at first use), self-play, replay, the learner,
checkpoints, evaluation and the `MuZero` orchestrator with its CLI.

Public API mirrors the reference's `MuZero` class (reference muzero.py:24):

    from muzero_general_tpu_torch import MuZero
    mz = MuZero("cartpole")
    mz.train()
    mz.test(num_tests=10)

Every entry point takes `device=None`, meaning "cuda"; with no card present
it raises unless the caller passes `device="cpu"`. Importing the package
needs neither a card nor nvcc.
"""

from muzero_general_tpu_torch.muzero import MuZero, hyperparameter_search

__version__ = "0.1.0"

__all__ = ["MuZero", "hyperparameter_search", "__version__"]
