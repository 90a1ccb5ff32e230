"""Network factory, batch-norm folding and the weight carry to and from the
JAX package (port of models/network.py).

`MuZeroNetwork(config)` dispatches on `config.network` like reference
models.py:7-41 and returns the module itself, in eval mode, on the device:
in PyTorch the module holds its weights, so no separate runner is needed.
"""

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.models.common import reset_parameters
from muzero_general_tpu_torch.models.fc import FCMuZero
from muzero_general_tpu_torch.models.resnet import ResMuZero

# flax leaf name -> torch state-dict name, per layer kind
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
_BN_FLAX = {name: leaf for leaf, name in _BN_LEAVES.items()}


def compute_dtype(config) -> torch.dtype:
    """The layers' compute dtype: bfloat16 if config.compute_dtype is
    "bfloat16", else float32 (JAX models/network.py:167-171)."""
    if getattr(config, "compute_dtype", "float32") == "bfloat16":
        return torch.bfloat16
    return torch.float32


def activation_dtype(config) -> torch.dtype:
    """The folded ResNet's activation dtype: bfloat16 when
    config.search_bf16_activations is on (JAX models/network.py:80-90)."""
    if getattr(config, "search_bf16_activations", False):
        return torch.bfloat16
    return torch.float32


def MuZeroNetwork(config, device=None,
                  seed: Optional[int] = None) -> Union[FCMuZero, ResMuZero]:
    """Build the config's network on `device` (None = "cuda") at the
    config's compute dtype (parameters stay float32).

    Weights get the TorchDense/TorchConv init, drawn from a generator seeded
    with `seed` (default config.seed).
    """
    device = resolve_device(device)
    dtype = compute_dtype(config)
    if config.network == "fullyconnected":
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
            dtype=dtype,
        )
    elif config.network == "resnet":
        module = ResMuZero(
            observation_shape=tuple(config.observation_shape),
            stacked_observations=config.stacked_observations,
            action_space_size=len(config.action_space),
            num_blocks=config.blocks,
            num_channels=config.channels,
            reduced_channels_reward=config.reduced_channels_reward,
            reduced_channels_value=config.reduced_channels_value,
            reduced_channels_policy=config.reduced_channels_policy,
            fc_reward_layers=tuple(config.resnet_fc_reward_layers),
            fc_value_layers=tuple(config.resnet_fc_value_layers),
            fc_policy_layers=tuple(config.resnet_fc_policy_layers),
            support_size=config.support_size,
            downsample=config.downsample,
            dtype=dtype,
        )
    else:
        raise NotImplementedError(
            'The network parameter should be "fullyconnected" or "resnet".'
        )
    generator = torch.Generator().manual_seed(
        config.seed if seed is None else seed
    )
    reset_parameters(module, generator)
    return module.to(device).eval()


@torch.no_grad()
def fold_bn(network: ResMuZero, act_dtype: torch.dtype = torch.float32) -> ResMuZero:
    """Fold every batch norm into its preceding conv (inference only).

    The counterpart of the JAX package's fold_bn_variables
    (models/network.py:20-67): in every scope, TorchConv_i followed by
    BatchNorm_i becomes a biased conv with
      weight' = weight * s,   bias' = beta - mean * s (+ bias * s),
      s = gamma * rsqrt(running_var + eps)   (per output channel).
    The fold runs in float32 on the float32 parameters. Returns a new
    fold_bn=True module on the same device, at the network's compute dtype
    with activations in `act_dtype` (activation_dtype(config)); at float32
    activations its outputs equal the network's up to float reassociation,
    with no normalization pass.
    """
    modules = dict(network.named_modules())
    state = {}
    for name, module in modules.items():
        if isinstance(module, nn.Linear):
            state[f"{name}.weight"] = module.weight
            state[f"{name}.bias"] = module.bias
        elif isinstance(module, nn.Conv2d):
            scope, _, leaf = name.rpartition(".")
            bn = modules.get(f"{scope}.BatchNorm_{leaf.split('_', 1)[1]}")
            if bn is None:
                state[f"{name}.weight"] = module.weight
                if module.bias is not None:
                    state[f"{name}.bias"] = module.bias
                continue
            s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            bias = bn.bias - bn.running_mean * s
            if module.bias is not None:
                bias = bias + module.bias * s
            state[f"{name}.weight"] = module.weight * s[:, None, None, None]
            state[f"{name}.bias"] = bias
    folded = network.folded_twin(act_dtype)
    folded.load_state_dict(state)
    return folded


def _flatten(tree: dict, prefix: str = ""):
    """Nested flax dicts -> {(scope, leaf_name): array}."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield (prefix.rstrip("."), key), value


def params_from_jax(variables: dict) -> dict:
    """Map a flax FCMuZero or ResMuZero variable tree onto the port's state
    dict (load it with `module.load_state_dict`).

    `variables` is the dict saved in model.checkpoint "weights"
    ({"params": ..., "batch_stats": ...} for a ResNet) or, for an FC net,
    its "params" subtree. Layers map by name:
    - TorchDense kernels [in, out] become nn.Linear weights [out, in];
    - TorchConv kernels HWIO become nn.Conv2d weights OIHW;
    - BatchNorm scale/bias (params) and mean/var (batch_stats) become
      weight/bias/running_mean/running_var.
    The ResNet heads flatten in the JAX (h, w, c) order (models/resnet.py),
    so their dense kernels need no row permutation. Returns CPU float32
    tensors.
    """
    params = variables.get("params", variables)
    stats = variables.get("batch_stats", {})
    state = {}
    for (scope, leaf), value in _flatten(params):
        x = np.asarray(value, np.float32)
        layer = scope.rpartition(".")[2]
        if layer.startswith("BatchNorm_"):
            name = _BN_LEAVES[leaf]
        elif leaf == "kernel":
            name = "weight"
            x = x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T
        else:
            name = leaf
        state[f"{scope}.{name}"] = torch.from_numpy(np.array(x))
    for (scope, leaf), value in _flatten(stats):
        x = np.asarray(value, np.float32)
        state[f"{scope}.{_BN_LEAVES[leaf]}"] = torch.from_numpy(x.copy())
        state[f"{scope}.num_batches_tracked"] = torch.tensor(0)
    return state


def params_to_jax(source) -> dict:
    """The inverse of params_from_jax: a module's (or a state dict's)
    tensors as the flax variable tree {"params": ..., "batch_stats": ...}
    of numpy float32 arrays, `batch_stats` {} for an FC net.

    nn.Linear weights [out, in] go back to TorchDense kernels [in, out],
    nn.Conv2d weights OIHW to TorchConv kernels HWIO, and batch-norm
    weight/bias/running_mean/running_var to scale/bias (params) and
    mean/var (batch_stats); num_batches_tracked has no flax counterpart. A
    dict of some parameters' tensors (the optimizer's moments) maps the
    same way into "params".
    """
    state = source.state_dict() if isinstance(source, nn.Module) else source
    variables = {"params": {}, "batch_stats": {}}
    for name, value in state.items():
        scope, _, leaf = name.rpartition(".")
        if leaf == "num_batches_tracked":
            continue
        x = value.detach().to("cpu", torch.float32).numpy()
        collection = "params"
        if scope.rpartition(".")[2].startswith("BatchNorm_"):
            if leaf.startswith("running_"):
                collection = "batch_stats"
            leaf = _BN_FLAX[leaf]
        elif leaf == "weight":
            leaf = "kernel"
            x = x.transpose(2, 3, 1, 0) if x.ndim == 4 else x.T
        node = variables[collection]
        for key in scope.split("."):
            node = node.setdefault(key, {})
        node[leaf] = np.array(x, np.float32, order="C")
    return variables
