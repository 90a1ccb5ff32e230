"""One row of the node-major hidden store, written in place (port of
muzero_general_tpu/ops/hidden_store.py).

The search's hidden store is [N, B, *rest] (node-major, ops/mcts.py) and
each simulation writes one node row. The JAX package wrote that row with a
one-block Pallas kernel (`_row_write_kernel`) whose output aliases the store,
so only the [B, F] row moves. Here `write_node_hidden` is a hand-written
CUDA kernel (csrc/hidden_store.cu) that reads `node` on the card, and
`write_node_hidden_plain` is its plain PyTorch version; the wrapper runs the
plain version on CPU tensors only.

Not the search's path, as in the JAX package (hidden_store.py:16-21): the
port's run_mcts writes `hidden[new_node] = leaf`, an in-place PyTorch copy.
This module is the counterpart of the JAX package's measured alternative,
exercised by chip_smoke.py as tools/hidden_store_bench.py exercises the JAX
one.
"""

import torch

from muzero_general_tpu_torch.ops.mcts_kernels import _check, _raise_on, _route


def write_node_hidden_plain(store, node, leaf):
    """store [N, B, *rest], node a 0-d int tensor, leaf [B, *rest]:
    store[node] = leaf (cast to the store's dtype) IN PLACE; a node outside
    [0, N) writes nothing, as the kernel. Returns the store."""
    n = int(node)
    if 0 <= n < store.shape[0]:
        store[n] = leaf
    return store


def write_node_hidden(store, node, leaf):
    """store[node] = leaf in place: the CUDA kernel for a CUDA store,
    write_node_hidden_plain for a CPU one; same arguments and result. On
    CUDA, node must be an int32 0-d tensor on the card (read there: no host
    sync), the store contiguous, and leaf [B, *rest] (cast to the store's
    dtype if it differs)."""
    device = store.device
    if _route("write_node_hidden", device) == "cpu":
        return write_node_hidden_plain(store, node, leaf)
    if store.dim() < 2:
        raise ValueError(f"store must be [N, B, ...], got shape {tuple(store.shape)}")
    _check("node", node, torch.int32, (), device)
    _check("store", store, store.dtype, tuple(store.shape), device)
    leaf = leaf.to(store.dtype).contiguous()
    _check("leaf", leaf, store.dtype, tuple(store.shape[1:]), device)

    from muzero_general_tpu_torch.native import build

    lib = build.load_library("hidden_store")
    row_bytes = leaf.numel() * leaf.element_size()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mcts_write_node_hidden(node.data_ptr(), leaf.data_ptr(), store.data_ptr(),
                                        store.shape[0], row_bytes, stream)
    _raise_on(rc, lib.hidden_store_error_string, "mcts_write_node_hidden")
    write_node_hidden.launches += 1
    return store


write_node_hidden.launches = 0  # kernel launches, counted where the kernel is launched
