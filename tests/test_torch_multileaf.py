"""The port's multi-leaf search (ops/mcts.py, SearchSpec.batch_leaves = K > 1)
against the JAX package's (ops/mcts.py _run_rounds_multileaf).

Both sides run the table network of tests/test_torch_mcts.py with
deterministic ties and the JAX side's own Dirichlet draw, on both routes:
the plain-op route (virtual marks between the selections, one multi-path
backprop) against the JAX XLA path, and the kernel route (the marking
descent and the pre-marked backprop, through their plain versions on CPU
tensors) against the JAX Pallas kernels in interpret mode. Root visits,
children_index, children_visit, root_visit and the tree depth must be
exact; value sums, rewards and min/max agree to the tolerances of
tests/test_torch_mcts.py (the support decode's rounding). The plain-op
route's multi-path backprop adds the K paths' value deltas with repeated
targets in one scatter-add, whose order of summation XLA on the CPU and
PyTorch's index_put_ need not share; the value sums are held to SUM_ATOL,
and visits, integer counts, are exact in any order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.ops import mcts as jax_mcts
from muzero_general_tpu_torch.ops import mcts as torch_mcts

from test_torch_mcts import (
    _assert_same_search,
    _inputs,
    _specs,
    _tables,
    jax_table_net,
    torch_table_net,
)


def run_both(K, num_players, kernels, B=8, A=5, sims=24, seed=0, legal=None,
             capture=True):
    tables = _tables(A, seed)
    obs, rand_legal, to_play = _inputs(B, A, seed + 1)
    legal = rand_legal if legal is None else legal
    jspec, tspec = _specs(num_players, sims, kernels)
    jspec = jspec._replace(batch_leaves=K, capture_path_stats=capture)
    tspec = tspec._replace(batch_leaves=K, capture_path_stats=capture)
    rng = jax.random.PRNGKey(seed)
    want = jax_mcts.run_mcts(
        *jax_table_net(tables, A), jnp.asarray(obs), jnp.asarray(legal),
        jnp.asarray(to_play), rng, jspec, add_exploration_noise=True,
    )
    # The JAX side's own Dirichlet Gamma draw (ops/mcts.py run_mcts).
    gamma = np.asarray(jax.random.gamma(jax.random.fold_in(rng, 0), jspec.dirichlet_alpha,
                                        (B, A)))
    got = torch_mcts.run_mcts(
        *torch_table_net(tables, A), torch.from_numpy(obs), torch.from_numpy(legal),
        torch.from_numpy(to_play), torch.Generator().manual_seed(seed), tspec,
        root_noise=torch.from_numpy(gamma.copy()), seed=seed,
    )
    return got, want, legal


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("K", [2, 4])
def test_multileaf_matches_jax(K, num_players, kernels):
    got, want, _ = run_both(K, num_players, kernels, seed=K + num_players)
    _assert_same_search(got, want)
    assert int(got.max_tree_depth.max()) >= 3


@pytest.mark.parametrize("kernels", [False, True])
def test_duplicate_selections_write_orphan_rows_as_jax(kernels):
    """One legal root action: all K selections of round 0 take the same
    unexpanded edge. The first expands it (node 1); each later one writes
    onto its own node row, a self-loop at action 0 that nothing links to."""
    K, B, A = 4, 6, 5
    legal = np.zeros((B, A), bool)
    legal[np.arange(B), np.arange(B) % A] = True
    got, want, _ = run_both(K, 2, kernels, B=B, A=A, sims=16, seed=5, legal=legal)
    # Every simulation goes down the one root edge, so backed-up values reach
    # ~80 here, not the ~30 ROOT_ATOL was set at: root values to 3e-4 (one
    # leaf per simulation on these inputs differs from JAX by 1.8e-4).
    _assert_same_search(got, want, root_atol=3e-4)
    index = got.tree.children_index
    lanes = torch.arange(B)
    assert torch.equal(index[lanes, 0, torch.from_numpy(legal.argmax(1))],
                       torch.ones(B, dtype=torch.int32))
    for node in range(2, K + 1):
        assert torch.equal(index[:, node, 0], torch.full((B,), node, dtype=torch.int32))
    assert torch.equal(got.root_visit_counts.sum(1), torch.full((B,), 16))


def test_plain_op_route_without_captured_stats_matches_jax():
    """The gomoku-shaped plain-op route at K > 1: from_config turns the path
    capture off above 256 simulations, so the backprop gathers the edge
    stats after the round's marks."""
    got, want, _ = run_both(4, 2, False, B=4, A=16, sims=32, seed=9, capture=False)
    _assert_same_search(got, want)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("K", [2, 4, 8])
def test_multileaf_invariants(K, kernels):
    """tests/test_multileaf.py's invariants on the port: visits sum to the
    simulation count, illegal root actions get none, and along every
    reachable edge the visits cover the child's (a duplicate-selection round
    credits one edge with two simulations while one node slot stays
    reachable, hence >=)."""
    B, A, sims = 8, 4, 24
    tables = _tables(A, 13)
    obs, legal, to_play = _inputs(B, A, 14)
    _, spec = _specs(2, sims, kernels)
    spec = spec._replace(batch_leaves=K)
    out = torch_mcts.run_mcts(
        *torch_table_net(tables, A), torch.from_numpy(obs), torch.from_numpy(legal),
        torch.from_numpy(to_play), torch.Generator().manual_seed(0), spec)
    visits = out.root_visit_counts
    assert bool((visits.sum(1) == sims).all())
    assert not bool(visits[~torch.from_numpy(legal)].any())
    assert torch.equal(out.tree.root_visit, torch.full((B,), sims, dtype=torch.int32))
    depth = out.max_tree_depth
    assert bool(((depth >= 1) & (depth <= sims)).all())
    ci, cv = out.tree.children_index.numpy(), out.tree.children_visit.numpy()
    for b in range(B):
        frontier = [0]
        while frontier:
            n = frontier.pop()
            for a in range(A):
                c = ci[b, n, a]
                if c >= 0:
                    assert cv[b, n, a] >= 1 + cv[b, c].sum()
                    frontier.append(c)
    assert np.isfinite(out.root_value.numpy()).all()


def test_multileaf_num_steps_must_be_whole_rounds():
    B, A = 4, 3
    tables = _tables(A, 1)
    obs, legal, to_play = _inputs(B, A, 2)
    _, spec = _specs(1, 12, False)
    args = (*torch_table_net(tables, A), torch.from_numpy(obs), torch.from_numpy(legal),
            torch.from_numpy(to_play), None, spec._replace(batch_leaves=4))
    with pytest.raises(ValueError, match="multiple"):
        torch_mcts.run_mcts(*args, num_steps=6)
    out = torch_mcts.run_mcts(*args, num_steps=8)
    assert bool((out.root_visit_counts.sum(1) == 8).all())
