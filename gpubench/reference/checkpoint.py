"""The reference's own reader of a shipped checkpoint file (a pickled dict
whose "weights" are flax's variable tree of numpy arrays).

Only numpy's classes are resolved; any other class the pickle names (the
optimizer state's, from optax) becomes an inert tuple, so reading a
checkpoint imports neither optax nor JAX. The tree maps onto the network's
state-dict names: conv kernels HWIO to OIHW, dense kernels [in, out] to
[out, in], batch norms' scale/bias/mean/var to
weight/bias/running_mean/running_var."""

import pickle

import numpy as np
import torch

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


class _Inert(tuple):
    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _NumpyOnly(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".", 1)[0] == "numpy":
            return super().find_class(module, name)
        return type(name, (_Inert,), {"__module__": "gpubench.inert"})


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield prefix.rstrip("."), key, value


def load_weights(path, device):
    """{state-dict name: float32 tensor on `device`} of the checkpoint."""
    with open(path, "rb") as f:
        weights = _NumpyOnly(f).load()["weights"]
    params = {}
    for collection in ("params", "batch_stats"):
        for scope, leaf, value in _flatten(weights.get(collection, {})):
            x = np.asarray(value, np.float32)
            if scope.rpartition(".")[2].startswith("BatchNorm_"):
                name = _BN[leaf]
            elif leaf == "kernel":
                name = "weight"
                x = x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T
            else:
                name = leaf
            params[f"{scope}.{name}"] = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return params
