"""The hidden-store row write's plain version (ops/hidden_store.py) against
the JAX package's Pallas kernel in interpret mode (ops/hidden_store.py
write_node_hidden). A copy: every element is compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.ops.hidden_store import write_node_hidden as jax_write
from muzero_general_tpu_torch.ops import hidden_store


@pytest.mark.parametrize("rest", [(12,), (4, 3, 2)])
def test_row_write_plain_matches_pallas_interpret(rest):
    """[N, B, F] and an N-D rest: row `node` replaced, every other row as it
    was."""
    N, B = 7, 5
    rng = np.random.default_rng(len(rest))
    store = rng.normal(size=(N, B) + rest).astype(np.float32)
    leaf = rng.normal(size=(B,) + rest).astype(np.float32)
    for node in (0, 3, N - 1):
        want = np.asarray(jax_write(jnp.asarray(store), node, jnp.asarray(leaf),
                                    interpret=True))
        got = torch.from_numpy(store.copy())
        out = hidden_store.write_node_hidden_plain(got, torch.tensor(node, dtype=torch.int32),
                                                   torch.from_numpy(leaf))
        assert out is got  # in place
        np.testing.assert_array_equal(got.numpy(), want)
        others = np.arange(N) != node
        np.testing.assert_array_equal(got.numpy()[others], store[others])


def test_row_write_casts_to_the_store_dtype_and_skips_nodes_out_of_range():
    store = torch.zeros((4, 2, 3), dtype=torch.float64)
    leaf = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    hidden_store.write_node_hidden_plain(store, torch.tensor(2), leaf)
    assert store.dtype == torch.float64 and torch.equal(store[2], leaf.double())
    want = store.clone()
    for node in (-1, 4):
        hidden_store.write_node_hidden_plain(store, torch.tensor(node), leaf + 1)
    assert torch.equal(store, want)


def test_row_write_wrapper_takes_the_plain_version_only_on_cpu():
    store = torch.zeros((3, 2, 4))
    leaf = torch.ones((2, 4))
    before = hidden_store.write_node_hidden.launches
    hidden_store.write_node_hidden(store, torch.tensor(1, dtype=torch.int32), leaf)
    assert hidden_store.write_node_hidden.launches == before  # no kernel ran
    assert torch.equal(store[1], leaf) and not bool(store[0].any() or store[2].any())
    with pytest.raises(ValueError, match="CUDA or CPU"):
        hidden_store.write_node_hidden(store.to("meta"), torch.tensor(1), leaf.to("meta"))
