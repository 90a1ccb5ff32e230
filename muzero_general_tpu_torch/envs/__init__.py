"""Environment layer: batched torch envs (port of muzero_general_tpu/envs)."""

from muzero_general_tpu_torch.envs.core import TorchEnv

__all__ = ["TorchEnv"]
