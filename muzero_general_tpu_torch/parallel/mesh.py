"""Mesh construction and sharding layout (port of parallel/mesh.py).

The JAX package lays a `jax.sharding.Mesh` with axes ``dp`` and ``mp`` over
the devices of one process and lets XLA place the collectives. The port has
one process per device (a rank) and writes the collectives out:

- ``dp``: data parallel. Each rank trains on its rows of the global batch;
  the learner sums the gradients over its dp group in one flattened
  all_reduce a step, and the batch norms normalise with the whole dp
  batch's statistics (models/common.py BatchNorm). Self-play splits its G
  lanes over dp (selfplay.py), with no collectives.
- ``mp``: tensor parallel. Dense and conv layers whose output features pass
  JAX's rule (param_sharding) become column-parallel: each rank of the mp
  group holds a slice of the output features and their bias, computes its
  slice, and an all_gather rebuilds the activation (parallel/collectives.py).
  Everything else is replicated.

A `Mesh` is a [dp, mp] grid of ranks (rank dp_index * mp + mp_index) with
each rank's device, and the process groups of its dp groups (ranks sharing
an mp index, whose gradients are summed) and mp groups (ranks sharing a dp
index, whose layer slices are gathered). Built without a process group it
is a layout only (param_sharding reads its shape).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from muzero_general_tpu_torch.parallel import collectives
from muzero_general_tpu_torch.parallel import distributed as dist_lib

# Output feature counts below this stay replicated: the all_gather would
# cost more than the sharded product saves (JAX mesh.py:23-25).
MP_MIN_FEATURES = 256


class Mesh:
    def __init__(self, ranks, devices):
        self.ranks = np.asarray(ranks).reshape(np.shape(ranks)[0], -1)
        dp, mp = self.ranks.shape
        self.shape = {"dp": dp, "mp": mp}
        self.devices = [torch.device(d) for d in devices]
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        here = np.argwhere(self.ranks == self.rank)
        self.dp_index, self.mp_index = (int(i) for i in here[0]) if len(here) else (0, 0)
        self.device = self.devices[self.rank] if self.rank < len(self.devices) else None
        self._dp_groups = self._mp_groups = None
        if dist.is_initialized():
            # Every rank creates every group, in the same order.
            if dp > 1:
                self._dp_groups = [dist.new_group(self.ranks[:, j].tolist()) for j in range(mp)]
            if mp > 1:
                self._mp_groups = [dist.new_group(self.ranks[i].tolist()) for i in range(dp)]

    @property
    def size(self) -> int:
        return self.ranks.size

    @property
    def dp_group(self):
        """The ranks that share this rank's mp index (None at dp 1)."""
        return self._dp_groups[self.mp_index] if self._dp_groups else None

    @property
    def mp_group(self):
        """The ranks that share this rank's dp index (None at mp 1)."""
        return self._mp_groups[self.dp_index] if self._mp_groups else None

    def __repr__(self):
        return f"Mesh(dp={self.shape['dp']}, mp={self.shape['mp']}, rank={self.rank})"


class Sharding(NamedTuple):
    """Where an array lives on a mesh: `spec` names, for each leading axis,
    the mesh axis it is split over ("dp", "mp") or None; () is replicated."""

    mesh: Mesh
    spec: tuple = ()

    def local(self, x) -> torch.Tensor:
        """This rank's block of the global array `x`, on its device."""
        x = torch.as_tensor(x)
        for axis, name in enumerate(self.spec):
            if name is None:
                continue
            n = self.mesh.shape[name]
            if x.shape[axis] % n:
                raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split over {name}={n}")
            size = x.shape[axis] // n
            index = self.mesh.dp_index if name == "dp" else self.mesh.mp_index
            x = x.narrow(axis, index * size, size)
        return x.to(self.mesh.device)


def _world_devices():
    """Every rank's device, in rank order."""
    if not dist.is_initialized():
        return [dist_lib.device() or torch.device("cpu")]
    devices = [None] * dist.get_world_size()
    dist.all_gather_object(devices, str(dist_lib.device()))
    return devices


def create_mesh(num_dp: Optional[int] = None, num_mp: int = 1, devices=None) -> Mesh:
    """A [num_dp, num_mp] mesh over the first num_dp * num_mp ranks
    (`devices`: each rank's device; by default the process group's)."""
    devices = list(devices) if devices is not None else _world_devices()
    if num_dp is None:
        num_dp = len(devices) // num_mp
    if num_dp * num_mp > len(devices):
        raise ValueError(f"a {num_dp} x {num_mp} mesh needs {num_dp * num_mp} devices, "
                         f"got {len(devices)}")
    return Mesh(np.arange(num_dp * num_mp).reshape(num_dp, num_mp),
                devices[: num_dp * num_mp])


# replicated, batch_sharding, stacked_batch_sharding and the two
# make_sharded_* are JAX's parallel/ names (its __all__), kept for parity;
# the training loop calls shard_train_state and the learner's steps.
def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis dp sharding for batches."""
    return Sharding(mesh, ("dp",))


def stacked_batch_sharding(mesh: Mesh) -> Sharding:
    """[M, B, ...] fused-train batch stacks: dp on the batch axis."""
    return Sharding(mesh, (None, "dp"))


def _out_features(layer) -> int:
    return getattr(layer, "full_out_features", layer.weight.shape[0])


def mp_layers(network: nn.Module, mp: int):
    """[(name, layer)] of the dense and conv layers that JAX's rule shards
    over mp: an output feature count (the last axis of a JAX kernel, the
    first of a torch weight) of at least MP_MIN_FEATURES that mp divides."""
    from muzero_general_tpu_torch.models.common import Conv, Dense

    if mp <= 1:
        return []
    return [(name, m) for name, m in network.named_modules()
            if isinstance(m, (Dense, Conv)) and _out_features(m) >= MP_MIN_FEATURES
            and _out_features(m) % mp == 0]


def param_sharding(network: nn.Module, mesh: Mesh) -> dict:
    """{parameter name: Sharding}: a sharded layer's weight and bias split
    their output axis over mp, everything else is replicated."""
    sharded = {f"{name}.{leaf}" for name, m in mp_layers(network, mesh.shape["mp"])
               for leaf in ("weight", "bias") if getattr(m, leaf) is not None}
    return {name: Sharding(mesh, ("mp",)) if name in sharded else replicated(mesh)
            for name, _ in network.named_parameters()}


def shard_train_state(learner, mesh: Mesh):
    """Put a learner on the mesh, in place (returns it): its network's
    mp-sharded layers keep their slice of the weights, bias and optimizer
    moments (the rank's mp_index-th block of output features) and gather
    their outputs over the mp group; its batch norms take the dp group's
    statistics; its steps sum gradients over the dp group. Load the full
    weights and optimizer state first (checkpoint.restore_learner)."""
    from muzero_general_tpu_torch.models.common import BatchNorm
    from muzero_general_tpu_torch.trainer import make_optimizer, make_schedule

    if learner.mesh is not None:
        raise ValueError(f"the learner is already on {learner.mesh}")
    network, mp = learner.network, mesh.shape["mp"]
    names = [name for name, _ in network.named_parameters()]
    opt_state = learner.optimizer.state_dict()
    count = learner.scheduler.last_epoch
    blocks = {}
    for name, layer in mp_layers(network, mp):
        out = _out_features(layer)
        size = out // mp
        lo = mesh.mp_index * size
        for leaf in ("weight", "bias"):
            p = getattr(layer, leaf)
            if p is not None:
                setattr(layer, leaf, nn.Parameter(p.detach()[lo:lo + size].clone()))
                blocks[f"{name}.{leaf}"] = (out, lo, size)
        layer.full_out_features = out
        layer.mp_group = mesh.mp_group
    for index, state in opt_state["state"].items():
        if names[index] in blocks:
            out, lo, size = blocks[names[index]]
            for key, value in state.items():
                if torch.is_tensor(value) and value.dim() and value.shape[0] == out:
                    state[key] = value[lo:lo + size].clone()
    learner.optimizer = make_optimizer(learner.config, network.parameters())
    learner.optimizer.load_state_dict(opt_state)
    learner.scheduler = make_schedule(learner.optimizer, learner.config, count)
    for module in network.modules():
        if isinstance(module, BatchNorm):
            module.dp_group = mesh.dp_group
    learner.mesh = mesh
    learner.sharded_names = set(blocks)
    return learner


def gather_sharded(tensors: dict, learner) -> dict:
    """`tensors` ({parameter name: tensor}, e.g. the state dict or an
    optimizer moment) with every mp-sharded entry gathered into its full
    array over the mp group. Every rank of the group must call it."""
    mesh = learner.mesh
    if mesh is None or mesh.mp_group is None:
        return tensors
    return {name: collectives.gather_cat(value, mesh.mp_group)
            if name in learner.sharded_names else value for name, value in tensors.items()}


def all_reduce_flat(tensors, group):
    """Sum `tensors` over `group` in one all_reduce of their flattened
    concatenation; returns the summed tensors (new, same shapes)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return out


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch dict (leading axis over dp), on
    its device."""
    s = batch_sharding(mesh)
    return {k: s.local(v) for k, v in batch.items()}


def shard_stacked_batches(batches: dict, mesh: Mesh) -> dict:
    """This rank's rows of an [M, B, ...] batch-stack dict (axis 1 over
    dp), on its device."""
    s = stacked_batch_sharding(mesh)
    return {k: s.local(v) for k, v in batches.items()}


def make_sharded_train_step(learner, mesh: Mesh):
    """The mesh's train step (JAX mesh.py:98-109): the learner's train_step
    on its rank's rows (shard_batch), once the learner is on the mesh."""
    if learner.mesh is None:
        shard_train_state(learner, mesh)
    if learner.mesh is not mesh:
        raise ValueError(f"the learner is on {learner.mesh}, not {mesh}")
    return learner.train_step


def make_sharded_fused_train_steps(learner, mesh: Mesh):
    """Mesh variant of the fused M-step call (JAX mesh.py:124-129): the
    learner's train_steps on its rank's rows (shard_stacked_batches)."""
    make_sharded_train_step(learner, mesh)
    return learner.train_steps


def mesh_shape(config, num_devices: int):
    """(dp, mp) of the product-path mesh over `num_devices`, or None for a
    one-device mesh. config.mesh_dp None gives every device mp leaves to
    dp. Raises when dp * mp exceeds the devices (JAX mesh.py:131-155)."""
    mp = max(1, int(getattr(config, "mesh_mp", 1) or 1))
    dp = config.mesh_dp if getattr(config, "mesh_dp", None) else max(1, num_devices // mp)
    if dp * mp <= 1:
        return None
    if dp * mp > num_devices:
        raise ValueError(f"mesh_dp*mesh_mp = {dp}*{mp} exceeds {num_devices} devices")
    return int(dp), mp


def mesh_from_config(config, devices=None) -> Optional[Mesh]:
    """The product-path mesh: dp x mp over `devices` (by default every
    rank's), or None when it would be a one-device mesh (single-device
    runs skip the sharding machinery entirely)."""
    devices = list(devices) if devices is not None else _world_devices()
    shape = mesh_shape(config, len(devices))
    if shape is None:
        return None
    return create_mesh(*shape, devices=devices)
