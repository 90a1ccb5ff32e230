"""Model layer: the FC MuZero network triplet (ResNet: ROADMAP module item 12)."""

from muzero_general_tpu_torch.models.network import MuZeroNetwork, params_from_jax

__all__ = ["MuZeroNetwork", "params_from_jax"]
