"""muzero_general_tpu_torch — the PyTorch/CUDA port of muzero_general_tpu.

A second package beside the JAX one, which stays the reference it is held
against (tests/test_torch_*.py). Module layout and names mirror the JAX
package so each module's counterpart is easy to find. The port so far covers
self-play on one GPU for fully connected networks: config, support codecs,
the FC network with a loader for the JAX checkpoints, the batched cartpole
env, observation stacking, and the fused MCTS search as a hand-written CUDA
kernel (csrc/mcts_fused.cu) driven by `selfplay.SelfPlayDriver`.

Every entry point takes `device=None`, meaning "cuda"; with no card present
it raises unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
