"""The port's stream route (ops/mcts_stream.py and run_mcts with use_stream)
against the JAX package's, whose Pallas kernels run in interpret mode.

Both sides run the table network of tests/test_torch_mcts.py, so logits are
bit-identical, with deterministic ties (interpret mode has no tie jitter).
The search then agrees exactly on visit counts, tree indices and depth, and
on values to that file's tolerances (the support decode rounds differently
in the two frameworks).

The kernels' plain versions are held against the JAX kernels on real packed
slabs: every descend output exactly, and the slab's live rows after an
update exactly (one float32 add per target on both sides). Masked path
levels aim at the dummy row N, as backprop_stream aims them; the dummy row
itself may differ (the JAX kernel adds zero there). Through
backprop_stream, value sums and min/max agree to RTOL = 1e-6 with one
player: XLA on the CPU contracts the scan's `a * b + c` into a fused
multiply-add in the JAX fold, rounded once, where the port rounds the
product and the sum. With two players the discount is 1 and they are exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.ops import mcts as jax_mcts
from muzero_general_tpu.ops import mcts_stream as jax_stream
from muzero_general_tpu_torch.ops import mcts as torch_mcts
from muzero_general_tpu_torch.ops import mcts_stream

from test_torch_mcts import (SUPPORT, _assert_same_search, _inputs, _tables, jax_table_net,
                             torch_table_net)

B, A, SIMS = 8, 5, 25
RTOL = 1e-6  # see the module docstring
SLABS = ("children_index", "children_prior", "children_visit", "children_vsum",
         "children_reward")


def _specs(num_players, sims=SIMS):
    common = dict(
        num_simulations=sims, num_players=num_players, pb_c_base=19652.0,
        pb_c_init=1.25, discount=0.97 if num_players == 1 else 1.0,
        dirichlet_alpha=0.3, exploration_fraction=0.25, support_size=SUPPORT,
        max_depth=sims, deterministic_tie_break=True,
    )
    return (jax_mcts.SearchSpec(**common, use_stream=True, pallas_interpret=True),
            torch_mcts.SearchSpec(**common, use_stream=True))


def _run_jax(num_players, noise, seed, sims=SIMS, A=A):
    tables = _tables(A, seed)
    obs, legal, to_play = _inputs(B, A, seed + 1)
    jspec, _ = _specs(num_players, sims)
    rng = jax.random.PRNGKey(seed)
    out = jax_mcts.run_mcts(
        *jax_table_net(tables, A), jnp.asarray(obs), jnp.asarray(legal),
        jnp.asarray(to_play), rng, jspec, add_exploration_noise=noise,
    )
    gamma = np.asarray(jax.random.gamma(jax.random.fold_in(rng, 0), jspec.dirichlet_alpha,
                                        (B, A)))
    return out, (tables, obs, legal, to_play, gamma)


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("num_players", [1, 2])
def test_stream_route_matches_jax_stream_interpret(num_players, noise):
    # The seeds of test_torch_mcts.py's two route tests, whose trees keep
    # values in the range its tolerances were set for.
    want, (tables, obs, legal, to_play, gamma) = _run_jax(num_players, noise, seed=3 * noise)
    _, tspec = _specs(num_players)
    got = torch_mcts.run_mcts(
        *torch_table_net(tables, A), torch.from_numpy(obs), torch.from_numpy(legal),
        torch.from_numpy(to_play), torch.Generator().manual_seed(0), tspec,
        add_exploration_noise=noise, root_noise=torch.from_numpy(gamma.copy()), seed=0,
    )
    _assert_same_search(got, want)
    assert int(got.max_tree_depth.max()) >= 3


def test_stream_route_agrees_with_the_plain_op_route():
    """The stream route and the plain-op route run the same search."""
    tables = _tables(A, 7)
    obs, legal, to_play = _inputs(B, A, 8)
    _, spec = _specs(2)
    outs = [torch_mcts.run_mcts(
        *torch_table_net(tables, A), torch.from_numpy(obs), torch.from_numpy(legal),
        torch.from_numpy(to_play), None, spec._replace(use_stream=stream),
        add_exploration_noise=False) for stream in (False, True)]
    plain, stream = outs
    for name in ("children_index", "children_visit", "root_visit"):
        assert torch.equal(getattr(plain.tree, name), getattr(stream.tree, name)), name
    torch.testing.assert_close(plain.tree.children_vsum, stream.tree.children_vsum,
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(plain.max_tree_depth, stream.max_tree_depth)
    visits = stream.root_visit_counts
    assert bool((visits.sum(1) == SIMS).all())
    assert not bool(visits[~torch.from_numpy(legal)].any())


# ---- the kernels' plain versions against the JAX kernels ------------------


@functools.lru_cache(maxsize=None)
def _jax_slab(num_players, A=A):
    """A JAX stream-route tree of width A after SIMS simulations and its
    packed slab, numpy (one per player count and width, shared by the tests:
    copy before mutating)."""
    out, _ = _run_jax(num_players, True, seed=num_players, A=A)
    edges = np.array(jax_stream.pack_tree(out.tree, A))
    tree = {k: np.array(v) for k, v in out.tree._asdict().items()}
    return tree, edges, int(np.asarray(out.max_tree_depth).max())


def _descend_both(tree, edges, depth_bound, spec, tie_jitter=0.0, A=A):
    kw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
              pb_c_init=spec.pb_c_init, discount=spec.discount, A=A, max_depth=SIMS)
    want = jax_stream.descend_stream(
        0, depth_bound, jnp.asarray(edges), jnp.asarray(tree["root_legal"]),
        jnp.asarray(tree["min_value"]), jnp.asarray(tree["max_value"]), interpret=True, **kw)
    got = mcts_stream.descend_stream_plain(
        123, 7, torch.tensor(depth_bound, dtype=torch.int32), torch.from_numpy(edges),
        torch.from_numpy(tree["root_legal"]).to(torch.int32),
        torch.from_numpy(tree["min_value"]), torch.from_numpy(tree["max_value"]),
        tie_jitter=tie_jitter, **kw)
    flat = lambda out: [*out[:5], *out[5]]  # noqa: E731
    return flat(got), [np.asarray(w) for w in flat(want)]


NAMES = ("parent", "action", "leaf_depth", "path_n", "path_a", "path_r", "path_v", "path_s")


@pytest.mark.parametrize("num_players", [1, 2])
def test_descend_plain_matches_pallas_interpret(num_players):
    tree, edges, max_depth = _jax_slab(num_players)
    spec, _ = _specs(num_players)
    got, want = _descend_both(tree, edges, max_depth + 1, spec)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[2].min()) >= 1 and int(got[2].max()) >= 3
    assert got[3].shape == (SIMS + 1, B)  # depth-major


def test_descend_marks_lanes_cut_by_the_depth_bound():
    tree, edges, _ = _jax_slab(2)
    spec, _ = _specs(2)
    got, want = _descend_both(tree, edges, 2, spec)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    depth = got[2].numpy()
    assert (depth == -1).any() and (depth == 2).any()


def test_descend_jitter_is_the_philox_stream():
    """Tie jitter leaves clear choices alone; on an all-tied root the Philox
    stream of (seed; lane, simulation, level 0, action // 4) decides, as in
    the planar descent."""
    from muzero_general_tpu_torch.ops import philox

    tree, edges, max_depth = _jax_slab(1)
    spec, _ = _specs(1)
    plain, _ = _descend_both(tree, edges, max_depth + 1, spec)
    jittered, _ = _descend_both(tree, edges, max_depth + 1, spec, tie_jitter=1e-5)
    for g, w in zip(jittered, plain):
        assert torch.equal(g, w)
    flat = torch.zeros((B, 3, mcts_stream.S_PLANES, 128))
    flat[:, :, mcts_stream.P_CHILD] = -1.0
    flat[:, :, mcts_stream.P_PRIOR, :A] = 1.0 / A
    inf = torch.full((B,), np.inf)
    out = mcts_stream.descend_stream_plain(
        99, 3, torch.tensor(5, dtype=torch.int32), flat, torch.ones((B, A), dtype=torch.int32),
        inf, -inf, num_players=1, pb_c_base=19652.0, pb_c_init=1.25, discount=1.0, A=A,
        max_depth=2, tie_jitter=1e-5)
    bits = philox.jitter_bits(B, A, 3, 1, 99, torch.device("cpu"))[:, 0]
    assert torch.equal(out[1].long(), torch.argmax(bits, dim=1))
    assert torch.equal(out[2], torch.ones(B, dtype=torch.int32))
    assert torch.equal(out[3][1], torch.full((B,), -1, dtype=torch.int32))


def _live_paths(tree, edges, max_depth, spec, seed, A=A):
    """This slab's next descent, as backprop_stream hands it to the update:
    masked levels aimed at the dummy row N, action 0, delta and mask 0. Lane
    1 is made a depth-1 lane while the bound stays the batch's deepest."""
    got, _ = _descend_both(tree, edges, max_depth + 1, spec, A=A)
    leaf_depth = got[2].clone()
    leaf_depth[1] = 1
    D = SIMS + 1
    mask = torch.arange(D)[:, None] < leaf_depth[None, :].long()
    rng = np.random.default_rng(seed)
    delta = torch.from_numpy(rng.normal(size=(D, B)).astype(np.float32)) * mask
    pn = torch.where(mask, got[3], edges.shape[1] - 1)
    pa = torch.where(mask, got[4], 0)
    return leaf_depth, pn, pa, delta, mask.to(torch.float32), got


def _jax_scatter(edges, pn, pa, delta, mask):
    """backprop_stream's use_update_kernel=False branch (JAX
    mcts_stream.py:497-503) on these inputs."""
    D, Bn = pn.shape
    brow = jnp.broadcast_to(jnp.arange(Bn)[None, :], (D, Bn))
    out = jnp.asarray(edges).at[brow, pn, jax_stream.P_VSUM, pa].add(delta)
    return np.asarray(out.at[brow, pn, jax_stream.P_VISIT, pa].add(mask))


@pytest.mark.parametrize("num_players", [1, 2])
def test_update_plain_matches_pallas_interpret_and_scatter(num_players):
    tree, edges, max_depth = _jax_slab(num_players)
    spec, _ = _specs(num_players)
    leaf_depth, pn, pa, delta, mask, _ = _live_paths(tree, edges, max_depth, spec, seed=1)
    bound = int(leaf_depth.max())
    assert bound > 1 and int(leaf_depth.min()) == 1
    got = mcts_stream.update_edges_plain(torch.from_numpy(edges.copy()), pn, pa, delta, mask,
                                         torch.tensor(bound, dtype=torch.int32))
    args = [jnp.asarray(x.numpy()) for x in (pn, pa, delta, mask)]
    kernel = np.asarray(jax_stream.update_edges_stream(jnp.asarray(edges), *args, bound,
                                                       interpret=True))
    scatter = _jax_scatter(edges, *args)
    N = edges.shape[1] - 1
    for name, want in (("interpret", kernel), ("scatter", scatter)):
        np.testing.assert_array_equal(got.numpy()[:, :N], want[:, :N], err_msg=name)
    changed = (got.numpy() != edges)[:, :N, mcts_stream.P_VISIT]
    assert changed.sum() == int(leaf_depth.sum())  # one visit per live level


def test_update_skips_levels_past_the_bound():
    """A bound below a lane's depth stops the update there (the kernel's
    loop trip count), as in the JAX kernel."""
    tree, edges, max_depth = _jax_slab(2)
    spec, _ = _specs(2)
    _, pn, pa, delta, mask, _ = _live_paths(tree, edges, max_depth, spec, seed=2)
    got = mcts_stream.update_edges_plain(torch.from_numpy(edges.copy()), pn, pa, delta, mask, 1)
    want = np.asarray(jax_stream.update_edges_stream(
        jnp.asarray(edges), *(jnp.asarray(x.numpy()) for x in (pn, pa, delta, mask)), 1,
        interpret=True))
    N = edges.shape[1] - 1
    np.testing.assert_array_equal(got.numpy()[:, :N], want[:, :N])
    assert ((got.numpy() != edges)[:, :N, mcts_stream.P_VISIT]).sum() == B  # level 0 only


# A = 130 pads to A_pad = 256: the two 128-column chunks the CUDA descent
# reads a row in (one chunk at gomoku's A = 121).
WIDE = 130


@pytest.mark.parametrize("num_players", [1, 2])
def test_descend_plain_matches_pallas_interpret_on_a_two_chunk_slab(num_players):
    tree, edges, max_depth = _jax_slab(num_players, WIDE)
    assert edges.shape[-1] == 256
    spec, _ = _specs(num_players)
    for bound in (max_depth + 1, 2):  # every lane's leaf, then lanes cut at 2
        got, want = _descend_both(tree, edges, bound, spec, A=WIDE)
        for name, g, w in zip(NAMES, got, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[2].min()) == -1
    assert (edges[:, :-1, mcts_stream.P_PRIOR, 128:WIDE] > 0).any()  # a live second chunk


@pytest.mark.parametrize("num_players", [1, 2])
def test_update_plain_matches_pallas_interpret_on_a_two_chunk_slab(num_players):
    tree, edges, max_depth = _jax_slab(num_players, WIDE)
    spec, _ = _specs(num_players)
    leaf_depth, pn, pa, delta, mask, _ = _live_paths(tree, edges, max_depth, spec, seed=6,
                                                     A=WIDE)
    bound = int(leaf_depth.max())
    got = mcts_stream.update_edges_plain(torch.from_numpy(edges.copy()), pn, pa, delta, mask,
                                         torch.tensor(bound, dtype=torch.int32))
    want = np.asarray(jax_stream.update_edges_stream(
        jnp.asarray(edges), *(jnp.asarray(x.numpy()) for x in (pn, pa, delta, mask)), bound,
        interpret=True))
    N = edges.shape[1] - 1
    np.testing.assert_array_equal(got.numpy()[:, :N], want[:, :N])
    changed = (got.numpy() != edges)[:, :N, mcts_stream.P_VISIT]
    assert changed.sum() == int(leaf_depth.sum())


@pytest.mark.parametrize("use_update_kernel", [True, False])
@pytest.mark.parametrize("num_players", [1, 2])
def test_backprop_stream_matches_jax(num_players, use_update_kernel):
    """The whole depth-major fold on real paths, both update branches: the
    JAX one with its kernel in interpret mode or its scatter fallback."""
    tree, edges, max_depth = _jax_slab(num_players)
    jspec, tspec = _specs(num_players)
    leaf_depth, _, _, _, _, got = _live_paths(tree, edges, max_depth, jspec, seed=3)
    path_n, path_a = got[3], got[4]
    stats = tuple(x.clone() for x in got[5:])
    leaf_value = torch.from_numpy(np.random.default_rng(4).normal(size=B).astype(np.float32))
    jtree = jax_mcts.Tree(**{k: jnp.asarray(v) for k, v in tree.items()})
    want_tree, want_edges = jax_stream.backprop_stream(
        jtree, jnp.asarray(edges), jnp.asarray(path_n.numpy()), jnp.asarray(path_a.numpy()),
        jnp.asarray(leaf_depth.numpy()), jnp.asarray(leaf_value.numpy()),
        tuple(jnp.asarray(x.numpy()) for x in stats), jspec,
        use_update_kernel=use_update_kernel, interpret=True)
    ttree = torch_mcts.Tree(**{k: torch.from_numpy(v.copy()) for k, v in tree.items()})
    t_edges = torch.from_numpy(edges.copy())
    mcts_stream.backprop_stream(ttree, t_edges, path_n, path_a, leaf_depth, leaf_value, stats,
                                tspec, use_update_kernel=use_update_kernel)
    N = edges.shape[1] - 1
    rtol = RTOL if num_players == 1 else 0.0
    for name, g, w in (("edges", t_edges.numpy()[:, :N], np.asarray(want_edges)[:, :N]),
                       ("root_visit", ttree.root_visit.numpy(), want_tree.root_visit),
                       ("root_vsum", ttree.root_vsum.numpy(), want_tree.root_vsum),
                       ("min_value", ttree.min_value.numpy(), want_tree.min_value),
                       ("max_value", ttree.max_value.numpy(), want_tree.max_value)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=0, err_msg=name)
    visits = t_edges[:, :N, mcts_stream.P_VISIT] - torch.from_numpy(edges[:, :N, 0])
    assert int(visits.sum()) == int(leaf_depth.sum())


def test_backprop_update_branches_agree():
    """The port's two update branches give the same live rows."""
    tree, edges, max_depth = _jax_slab(1)
    _, tspec = _specs(1)
    leaf_depth, _, _, _, _, got = _live_paths(tree, edges, max_depth, tspec, seed=5)
    outs = []
    for use_update_kernel in (True, False):
        ttree = torch_mcts.Tree(**{k: torch.from_numpy(v.copy()) for k, v in tree.items()})
        t_edges = torch.from_numpy(edges.copy())
        mcts_stream.backprop_stream(ttree, t_edges, got[3], got[4], leaf_depth,
                                    torch.linspace(-1.0, 2.0, B), got[5:], tspec,
                                    use_update_kernel=use_update_kernel)
        outs.append((t_edges[:, :-1], ttree))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


# ---- the slab --------------------------------------------------------------


def test_pack_tree_matches_jax_and_round_trips():
    rng = np.random.default_rng(0)
    Bn, N, An = 2, 5, 3
    tree = jax_mcts.init_tree(
        N, jnp.asarray(rng.dirichlet(np.ones(An), Bn).astype(np.float32)),
        jnp.ones((Bn, An), bool), jnp.zeros((Bn,), jnp.int32), jnp.zeros((Bn,), jnp.float32))
    tree = tree._replace(
        children_index=jnp.asarray(rng.integers(-1, N, (Bn, N, An)).astype(np.int32)),
        children_visit=jnp.asarray(rng.integers(0, 9, (Bn, N, An)).astype(np.int32)),
        children_vsum=jnp.asarray(rng.normal(size=(Bn, N, An)).astype(np.float32)),
        children_reward=jnp.asarray(rng.normal(size=(Bn, N, An)).astype(np.float32)))
    want = np.asarray(jax_stream.pack_tree(tree, An))
    ttree = torch_mcts.Tree(*(torch.from_numpy(np.array(x)) for x in tree))
    packed = mcts_stream.pack_tree(ttree, An)
    assert packed.shape == (Bn, N + 1, mcts_stream.S_PLANES, 128)  # + the dummy row
    np.testing.assert_array_equal(packed.numpy(), want)  # the dummy row and the padding too
    back = mcts_stream.unpack_tree(ttree, packed, An)
    for name in SLABS:
        assert torch.equal(getattr(back, name), getattr(ttree, name)), name
        assert getattr(back, name).dtype == getattr(ttree, name).dtype


def test_expand_packed_matches_jax():
    tree, edges, _ = _jax_slab(2)
    rng = np.random.default_rng(1)
    parent = rng.integers(0, SIMS, B).astype(np.int32)
    action = rng.integers(0, A, B).astype(np.int32)
    reward = rng.normal(size=B).astype(np.float32)
    prior = rng.dirichlet(np.ones(A), B).astype(np.float32)
    want = jax_stream.expand_packed(jnp.asarray(edges), jnp.asarray(parent),
                                    jnp.asarray(action), jnp.int32(SIMS), jnp.asarray(reward),
                                    jnp.asarray(prior), A)
    got = mcts_stream.expand_packed(torch.from_numpy(edges.copy()), torch.from_numpy(parent),
                                    torch.from_numpy(action), SIMS, torch.from_numpy(reward),
                                    torch.from_numpy(prior), A)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_take_the_plain_version_only_on_cpu():
    tree, edges, max_depth = _jax_slab(2)
    spec, _ = _specs(2)
    kw = dict(num_players=2, pb_c_base=spec.pb_c_base, pb_c_init=spec.pb_c_init,
              discount=spec.discount, A=A, max_depth=SIMS)
    args = (torch.tensor(max_depth + 1, dtype=torch.int32), torch.from_numpy(edges.copy()),
            torch.from_numpy(tree["root_legal"]).to(torch.int32),
            torch.from_numpy(tree["min_value"]), torch.from_numpy(tree["max_value"]))
    before = mcts_stream.descend_stream.launches
    got = mcts_stream.descend_stream(1, 0, *args, **kw)
    want = mcts_stream.descend_stream_plain(1, 0, *args, **kw)
    for g, w in zip([*got[:5], *got[5]], [*want[:5], *want[5]]):
        assert torch.equal(g, w)
    assert mcts_stream.descend_stream.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mcts_stream.descend_stream(1, 0, *(t.to("meta") for t in args), **kw)
    before = mcts_stream.update_edges.launches
    D = SIMS + 1
    zeros = torch.zeros((D, B))
    mcts_stream.update_edges(args[1], got[3].clamp(min=0), got[4], zeros, zeros, args[0])
    assert mcts_stream.update_edges.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mcts_stream.update_edges(args[1].to("meta"), got[3], got[4], zeros, zeros, args[0])


def test_build_declares_every_c_interface_as_the_sources_define_it():
    """native/build.py's ctypes declarations against the `extern "C"`
    signatures in each csrc/*.cu (no compiler here: a wrong count or type
    would only show on the card, as a cut pointer)."""
    import ctypes
    import re

    from muzero_general_tpu_torch.native import build

    def ctype(decl):
        decl = decl.strip()
        if "*" in decl:
            return ctypes.c_char_p if decl.startswith("const char") else "pointer"
        for word, t in (("unsigned long long", ctypes.c_ulonglong), ("float", ctypes.c_float),
                        ("int", ctypes.c_int)):
            if decl.startswith(word):
                return t
        raise AssertionError(decl)

    assert "mcts_stream" in build._KERNELS
    for name, entry in build._KERNELS.items():
        # The kernels held bit for bit against their plain versions are
        # built without FMA contraction; the probes' kernels are held to a
        # tolerance.
        bit_exact = name in ("mcts_fused", "mcts_kernels", "mcts_stream", "hidden_store")
        assert ("--fmad=false" in build.nvcc_flags(name)) == bit_exact, name
        source = (build.CSRC_DIR / f"{name}.cu").read_text()
        defined = {
            fn: (ctype(ret), [ctype(p) for p in params.split(",")])
            for ret, fn, params in re.findall(
                r'extern "C" ([\w ]+\*?) (\w+)\(([^)]*)\)', source)
        }
        declared = {fn: (r, ["pointer" if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer)
                             else t for t in a])
                    for fn, (r, a) in entry["api"].items()}
        assert defined == declared, name
