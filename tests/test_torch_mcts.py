"""The port's staged search (ops/mcts.py run_mcts) against the JAX package's.

Both sides run the same "table network": the hidden state carries an integer
node id, the recurrent step maps (id, action) to a new id, and every output
is looked up from numpy tables, so both frameworks see bit-identical logits.
With deterministic tie-breaking the searches then agree exactly on visit
counts, tree shape and depth, on both routes: the plain-op route against the
JAX package's XLA path (use_pallas=False), and the kernel route (the
kernels' plain versions on CPU tensors) against its Pallas kernels in
interpret mode (use_pallas=True).

Values agree only to tolerances: the support decode (softmax, expectation,
h^-1) rounds differently in the two frameworks, and h^-1's
sqrt(1 + 4 eps (|x| + 1 + eps)) - 1 cancels, so each decoded reward or
value is good to about 3e-5 relative (observed over the table's logits),
at |v| up to ~30 here. Node statistics (rewards, min/max) therefore agree
to STAT_ATOL = 1e-3, value sums over up to 25 such leaves to SUM_ATOL =
5e-3, and root values (a sum over 25 visits) to ROOT_ATOL = 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.ops import mcts as jax_mcts
from muzero_general_tpu_torch.ops import mcts as torch_mcts

STAT_ATOL, SUM_ATOL, ROOT_ATOL = 1e-3, 5e-3, 1e-4  # see the module docstring
SUPPORT = 5
TABLE = 97


def _tables(A, seed):
    rng = np.random.default_rng(seed)
    full = 2 * SUPPORT + 1
    return (
        rng.normal(size=(TABLE, full)).astype(np.float32),  # value logits
        rng.normal(size=(TABLE, full)).astype(np.float32),  # reward logits
        rng.normal(size=(TABLE, A)).astype(np.float32),  # policy logits
    )


def jax_table_net(tables, A):
    tv, tr, tp = (jnp.asarray(t) for t in tables)

    def initial_fn(obs):
        ids = obs[:, 0].astype(jnp.int32)
        return tv[ids], jnp.full_like(tr[ids], -1e9).at[:, SUPPORT].set(0.0), tp[ids], obs

    def recurrent_fn(h, a):
        ids = (h[:, 0].astype(jnp.int32) * A + a.astype(jnp.int32) + 1) % TABLE
        return tv[ids], tr[ids], tp[ids], ids[:, None].astype(jnp.float32)

    return initial_fn, recurrent_fn


def torch_table_net(tables, A):
    tv, tr, tp = (torch.from_numpy(t) for t in tables)

    def initial_fn(obs):
        ids = obs[:, 0].long()
        reward = torch.full_like(tr[ids], -1e9)
        reward[:, SUPPORT] = 0.0
        return tv[ids], reward, tp[ids], obs

    def recurrent_fn(h, a):
        ids = (h[:, 0].long() * A + a.long() + 1) % TABLE
        return tv[ids], tr[ids], tp[ids], ids[:, None].to(torch.float32)

    return initial_fn, recurrent_fn


def _specs(num_players, sims, kernels):
    common = dict(
        num_simulations=sims, num_players=num_players, pb_c_base=19652.0,
        pb_c_init=1.25, discount=0.97 if num_players == 1 else 1.0,
        dirichlet_alpha=0.3, exploration_fraction=0.25, support_size=SUPPORT,
        max_depth=sims, deterministic_tie_break=True,
    )
    jspec = jax_mcts.SearchSpec(**common, use_pallas=kernels, pallas_interpret=kernels)
    tspec = torch_mcts.SearchSpec(**common, use_kernels=kernels)
    return jspec, tspec


def _inputs(B, A, seed):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, TABLE, size=(B, 1)).astype(np.float32)
    legal = rng.random((B, A)) < 0.75
    legal[np.arange(B), rng.integers(0, A, size=B)] = True
    to_play = rng.integers(0, 2, size=B).astype(np.int32)
    return obs, legal, to_play


def run_both(num_players, kernels, noise, B=8, A=5, sims=25, seed=0):
    tables = _tables(A, seed)
    obs, legal, to_play = _inputs(B, A, seed + 1)
    jspec, tspec = _specs(num_players, sims, kernels)
    rng = jax.random.PRNGKey(seed)
    want = jax_mcts.run_mcts(
        *jax_table_net(tables, A), jnp.asarray(obs), jnp.asarray(legal),
        jnp.asarray(to_play), rng, jspec, add_exploration_noise=noise,
    )
    # The JAX side's own Dirichlet Gamma draw (ops/mcts.py run_mcts).
    gamma = np.asarray(jax.random.gamma(jax.random.fold_in(rng, 0), jspec.dirichlet_alpha,
                                        (B, A)))
    got = torch_mcts.run_mcts(
        *torch_table_net(tables, A), torch.from_numpy(obs), torch.from_numpy(legal),
        torch.from_numpy(to_play), torch.Generator().manual_seed(seed), tspec,
        add_exploration_noise=noise, root_noise=torch.from_numpy(gamma.copy()), seed=seed,
    )
    return got, want


def _assert_same_search(got, want, root_atol=ROOT_ATOL):
    np.testing.assert_array_equal(got.root_visit_counts.numpy(),
                                  np.asarray(want.root_visit_counts))
    np.testing.assert_array_equal(got.max_tree_depth.numpy(),
                                  np.asarray(want.max_tree_depth))
    for name in ("children_index", "children_visit", "root_visit"):
        np.testing.assert_array_equal(getattr(got.tree, name).numpy(),
                                      np.asarray(getattr(want.tree, name)), err_msg=name)
    for name, atol in (("children_vsum", SUM_ATOL), ("root_vsum", SUM_ATOL),
                       ("children_reward", STAT_ATOL), ("children_prior", 1e-6),
                       ("min_value", STAT_ATOL), ("max_value", STAT_ATOL)):
        np.testing.assert_allclose(getattr(got.tree, name).numpy(),
                                   np.asarray(getattr(want.tree, name)),
                                   atol=atol, rtol=0, err_msg=name)
    np.testing.assert_allclose(got.root_value.numpy(), np.asarray(want.root_value),
                               atol=root_atol, rtol=0)
    np.testing.assert_allclose(got.root_predicted_value.numpy(),
                               np.asarray(want.root_predicted_value),
                               atol=STAT_ATOL, rtol=0)


@pytest.mark.parametrize("num_players", [1, 2])
def test_plain_route_matches_jax_xla_path(num_players):
    got, want = run_both(num_players, kernels=False, noise=num_players == 2)
    _assert_same_search(got, want)
    assert int(got.max_tree_depth.max()) >= 3


@pytest.mark.parametrize("num_players", [1, 2])
def test_kernel_route_matches_jax_pallas_interpret(num_players):
    got, want = run_both(num_players, kernels=True, noise=num_players == 1, seed=3)
    _assert_same_search(got, want)
    assert int(got.max_tree_depth.max()) >= 3


def test_routes_agree_and_keep_search_invariants():
    """The two port routes run the same search: visits and tree equal."""
    B, A, sims = 6, 4, 20
    tables = _tables(A, 7)
    obs, legal, to_play = _inputs(B, A, 8)
    outs = []
    for kernels in (False, True):
        _, spec = _specs(2, sims, kernels)
        outs.append(torch_mcts.run_mcts(
            *torch_table_net(tables, A), torch.from_numpy(obs), torch.from_numpy(legal),
            torch.from_numpy(to_play), None, spec, add_exploration_noise=False))
    plain, kern = outs
    assert torch.equal(plain.root_visit_counts, kern.root_visit_counts)
    assert torch.equal(plain.tree.children_index, kern.tree.children_index)
    torch.testing.assert_close(plain.tree.children_vsum, kern.tree.children_vsum,
                               rtol=1e-5, atol=1e-6)
    visits = kern.root_visit_counts
    assert bool((visits.sum(1) == sims).all())
    assert not bool(visits[~torch.from_numpy(legal)].any())


def test_random_ties_are_seeded_and_uniform_over_winners():
    gen = torch.Generator().manual_seed(0)
    scores = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0]] * 4000)
    picks = torch_mcts._random_argmax(gen, scores)
    counts = torch.bincount(picks, minlength=5)
    assert counts[0] == counts[3] == 0
    assert all(1200 < int(c) < 1470 for c in counts[[1, 2, 4]])
    again = torch_mcts._random_argmax(torch.Generator().manual_seed(0), scores)
    assert torch.equal(picks, again)


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("capture", [False, True])
def test_backprop_vectorized_layouts_and_path_stats(planar, capture):
    """One plain-op backprop of real paths gives the same tree in both slab
    layouts, with or without the descent's captured path stats."""
    B, A, sims = 5, 4, 12
    tables = _tables(A, 11)
    obs, legal, to_play = _inputs(B, A, 12)
    _, spec = _specs(2, sims, False)
    spec = spec._replace(capture_path_stats=capture)
    out = torch_mcts.run_mcts(
        *torch_table_net(tables, A), torch.from_numpy(obs), torch.from_numpy(legal),
        torch.from_numpy(to_play), None, spec, add_exploration_noise=False,
        num_steps=sims - 1)
    tree = out.tree
    sel = torch_mcts._select_leaf(tree, None, spec, torch.tensor(sims), sims - 1, 0)
    leaf_value = torch.linspace(-1.0, 2.0, B)
    ref = torch_mcts.Tree(*(t.clone() for t in tree))
    torch_mcts._backprop_vectorized(ref, sel.path_nodes, sel.path_actions, sel.leaf_depth,
                                    leaf_value, spec)
    work = torch_mcts.Tree(*(t.clone() for t in tree))
    if planar:
        work = torch_mcts._to_planar(work)
    torch_mcts._backprop_vectorized(
        work, sel.path_nodes, sel.path_actions, sel.leaf_depth, leaf_value, spec,
        planar=planar, path_stats=sel.path_stats if capture else None)
    if planar:
        work = torch_mcts._from_planar(work)
    for a, b in zip(work, ref):
        assert torch.equal(a, b)
    assert int((ref.root_visit - tree.root_visit).min()) == 1


def test_search_spec_from_config_routes_like_jax():
    from muzero_general_tpu.games.connect4 import MuZeroConfig as JaxConnect4
    from muzero_general_tpu.games.gomoku import MuZeroConfig as JaxGomoku
    from muzero_general_tpu_torch.games.connect4 import MuZeroConfig

    cfg = MuZeroConfig()
    assert torch_mcts.SearchSpec.from_config(cfg, 256, "cuda").use_kernels
    assert not torch_mcts.SearchSpec.from_config(cfg, 256, "cpu").use_kernels  # "auto"
    cfg.use_pallas_mcts = True
    assert torch_mcts.SearchSpec.from_config(cfg, 256, "cpu").use_kernels
    for jcfg in (JaxConnect4(), JaxGomoku()):
        jcfg.use_pallas_mcts = jcfg.use_stream_mcts = True
        jspec = jax_mcts.SearchSpec.from_config(jcfg, batch_size=64)
        tspec = torch_mcts.SearchSpec.from_config(jcfg, 64, "cuda")
        assert tspec.use_kernels == jspec.use_pallas
        assert tspec.use_stream == jspec.use_stream  # gomoku streams
        assert tspec.capture_path_stats == jspec.capture_path_stats
    assert tspec.use_stream
    # Multi-leaf rounds: the planar kernels where they fit, the stream route
    # never (K = 1 only), as the JAX package routes them.
    for jcfg in (JaxConnect4(), JaxGomoku()):
        jcfg.use_pallas_mcts = jcfg.use_stream_mcts = True
        jcfg.search_batch_leaves = 8
        jspec = jax_mcts.SearchSpec.from_config(jcfg, batch_size=64)
        tspec = torch_mcts.SearchSpec.from_config(jcfg, 64, "cuda")
        assert tspec.batch_leaves == jspec.batch_leaves == jcfg.search_batch_leaves
        assert tspec.use_kernels == jspec.use_pallas
        assert tspec.use_stream == jspec.use_stream
        assert tspec.capture_path_stats == jspec.capture_path_stats
    assert not tspec.use_stream and not tspec.use_kernels  # gomoku: the plain-op route
    cfg.search_batch_leaves = 8
    spec = torch_mcts.SearchSpec.from_config(cfg, 256, "cuda")
    assert spec.use_kernels and spec.batch_leaves == 8
    cfg.search_batch_leaves = 7  # does not divide 200
    with pytest.raises(ValueError, match="divide"):
        torch_mcts.SearchSpec.from_config(cfg, 256, "cuda")


def test_search_spec_from_config_defaults_to_the_card():
    """device=None means the card, as at every entry point: without one it
    raises instead of quietly taking the CPU's plain-op route."""
    from muzero_general_tpu_torch.games.connect4 import MuZeroConfig

    if torch.cuda.is_available():
        assert torch_mcts.SearchSpec.from_config(MuZeroConfig(), 256).use_kernels
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_mcts.SearchSpec.from_config(MuZeroConfig(), 256)
