"""Model layer: the FC and ResNet MuZero network triplets."""

from muzero_general_tpu_torch.models.network import (
    MuZeroNetwork,
    activation_dtype,
    fold_bn,
    params_from_jax,
    params_to_jax,
)

__all__ = ["MuZeroNetwork", "activation_dtype", "fold_bn", "params_from_jax",
           "params_to_jax"]
