"""Network factory and the weight carry from the JAX package (port of the FC
branch of models/network.py).

`MuZeroNetwork(config)` dispatches on `config.network` like reference
models.py:7-41 and returns the module itself, in eval mode, on the device:
in PyTorch the module holds its weights, so no separate runner is needed.
"""

from typing import Optional

import numpy as np
import torch

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.models.fc import FCMuZero

FC_NETWORKS = (
    "representation_network",
    "dynamics_state_network",
    "dynamics_reward_network",
    "prediction_policy_network",
    "prediction_value_network",
)


def MuZeroNetwork(config, device=None, seed: Optional[int] = None) -> FCMuZero:
    """Build the config's network on `device` (None = "cuda").

    Weights get the torch.nn.Linear default init, drawn from a generator
    seeded with `seed` (default config.seed).
    """
    device = resolve_device(device)
    if config.network == "resnet":
        raise NotImplementedError(
            "the ResNet network is not ported yet (ROADMAP module item 12)"
        )
    if config.network != "fullyconnected":
        raise NotImplementedError(
            'The network parameter should be "fullyconnected" or "resnet".'
        )
    module = FCMuZero(
        observation_shape=tuple(config.observation_shape),
        stacked_observations=config.stacked_observations,
        action_space_size=len(config.action_space),
        encoding_size=config.encoding_size,
        fc_reward_layers=tuple(config.fc_reward_layers),
        fc_value_layers=tuple(config.fc_value_layers),
        fc_policy_layers=tuple(config.fc_policy_layers),
        fc_representation_layers=tuple(config.fc_representation_layers),
        fc_dynamics_layers=tuple(config.fc_dynamics_layers),
        support_size=config.support_size,
    )
    generator = torch.Generator().manual_seed(
        config.seed if seed is None else seed
    )
    module.reset_parameters(generator)
    return module.to(device).eval()


def params_from_jax(params: dict) -> dict:
    """Map a flax FCMuZero parameter tree onto FCMuZero's state dict.

    `params` is the variables dict ({"params": ...}, as saved in
    model.checkpoint "weights") or its "params" subtree:
    {<network>: {"TorchDense_<i>": {"kernel": [in, out], "bias": [out]}}}.
    Flax kernels are [in, out]; torch.nn.Linear weights are [out, in].
    Returns CPU float32 tensors; load with `module.load_state_dict`.
    """
    params = params.get("params", params)
    state = {}
    for name in FC_NETWORKS:
        for layer, leaves in params[name].items():
            prefix = f"{name}.{layer}"
            kernel = np.asarray(leaves["kernel"], np.float32)
            state[prefix + ".weight"] = torch.from_numpy(kernel.T.copy())
            state[prefix + ".bias"] = torch.from_numpy(
                np.asarray(leaves["bias"], np.float32).copy()
            )
    return state
