"""The tree kernels' plain versions (ops/mcts_kernels.py) against the JAX
package's Pallas kernels in interpret mode (ops/mcts_pallas.py).

Both sides get real trees: the tree of a JAX run_mcts at a small size (the
table network of tests/test_torch_mcts.py), in the planar [B, A, N] layout
the kernels read. Interpret mode has no tie jitter, so both run with 0. The
plain versions repeat the kernels' float32 operations in their order, so
descend outputs and visit counts are compared exactly. Value sums and
min/max agree to RTOL = 1e-6 (a few ulp): XLA on the CPU contracts the
one-player backup `reward + discount * value` into a fused multiply-add,
rounded once, where the port rounds the product and the sum (its kernel is
built with --fmad=false); with two players the discount is 1 and they are
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.ops import mcts as jax_mcts
from muzero_general_tpu.ops import mcts_pallas
from muzero_general_tpu_torch.ops import mcts_kernels, philox

from test_torch_mcts import _inputs, _specs, _tables, jax_table_net

B, A, SIMS = 8, 5, 25
RTOL = 1e-6  # see the module docstring
# One-player value sums and stats on the chain paths below: the FMA's
# rounding gap enters the value chain in the leaf value's units and is
# carried down the path, so a small value sum differs by ulps of the
# values, not of itself (measured: at most 9.5e-7, one ulp at the slab's
# largest magnitude, 14.4; 3.6e-6 relative on a sum of 0.13).
CHAIN_ATOL = 4e-6
SLABS = ("children_index", "children_prior", "children_visit", "children_vsum",
         "children_reward")


def _jax_tree(num_players, seed):
    """A JAX run_mcts tree after SIMS simulations, numpy, node-major."""
    tables = _tables(A, seed)
    obs, legal, to_play = _inputs(B, A, seed + 1)
    jspec, _ = _specs(num_players, SIMS, False)
    out = jax_mcts.run_mcts(
        *jax_table_net(tables, A), jnp.asarray(obs), jnp.asarray(legal),
        jnp.asarray(to_play), jax.random.PRNGKey(seed), jspec,
        add_exploration_noise=True,
    )
    tree = {k: np.array(v) for k, v in out.tree._asdict().items()}
    return tree, int(np.asarray(out.max_tree_depth).max()), jspec


def _planar(tree):
    return {k: (np.ascontiguousarray(v.transpose(0, 2, 1)) if k in SLABS else v)
            for k, v in tree.items()}


def _descend_both(tree, depth_bound, spec, tie_jitter=0.0):
    p = _planar(tree)
    kw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
              pb_c_init=spec.pb_c_init, discount=spec.discount, max_depth=SIMS)
    want = mcts_pallas.descend_planar(
        0, depth_bound, *(jnp.asarray(p[k]) for k in SLABS),
        jnp.asarray(p["root_legal"]), jnp.asarray(p["min_value"]),
        jnp.asarray(p["max_value"]), A=A, tie_jitter=0.0, interpret=True, **kw)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    got = mcts_kernels.descend_planar_plain(
        123, 7, torch.tensor(depth_bound, dtype=torch.int32),
        *(t[k] for k in SLABS), t["root_legal"].to(torch.int32), t["min_value"],
        t["max_value"], tie_jitter=tie_jitter, **kw)
    return got, [np.asarray(w) for w in want]


@pytest.mark.parametrize("num_players", [1, 2])
def test_descend_plain_matches_pallas_interpret(num_players):
    tree, max_depth, spec = _jax_tree(num_players, seed=num_players)
    got, want = _descend_both(tree, max_depth + 1, spec)
    for name, g, w in zip(("parent", "action", "leaf_depth", "path_n", "path_a"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[2].min()) >= 1 and int(got[2].max()) >= 3


def test_descend_marks_lanes_cut_by_the_depth_bound():
    tree, _, spec = _jax_tree(2, seed=5)
    got, want = _descend_both(tree, 2, spec)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    depth = got[2].numpy()
    assert (depth == -1).any() and (depth == 2).any()


def test_descend_jitter_is_the_philox_stream():
    """With tie jitter on, the plain descent adds bits * jitter / 2^32 from
    the Philox stream keyed by (seed; lane, simulation, level, action // 4):
    it breaks exact ties and leaves clear choices alone."""
    tree, max_depth, spec = _jax_tree(1, seed=4)
    plain, _ = _descend_both(tree, max_depth + 1, spec, tie_jitter=0.0)
    jittered, _ = _descend_both(tree, max_depth + 1, spec, tie_jitter=1e-5)
    for g, w in zip(jittered, plain):
        assert torch.equal(g, w)
    # An all-tied root: every action scores the same, so the jitter decides,
    # as the argmax of the stream's level-0 words for each lane.
    p = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _planar(tree).items()}
    idx = torch.full_like(p["children_index"], -1)
    prior = torch.full_like(p["children_prior"], 1.0 / A)
    zeros_i, zeros_f = torch.zeros_like(p["children_visit"]), torch.zeros_like(p["children_vsum"])
    legal = torch.ones((B, A), dtype=torch.int32)
    inf = torch.full((B,), np.inf)
    out = mcts_kernels.descend_planar_plain(
        99, 3, torch.tensor(5, dtype=torch.int32), idx, prior, zeros_i, zeros_f, zeros_f,
        legal, inf, -inf, num_players=1, pb_c_base=19652.0, pb_c_init=1.25,
        discount=1.0, max_depth=SIMS, tie_jitter=1e-5)
    bits = philox.jitter_bits(B, A, 3, 1, 99, torch.device("cpu"))[:, 0]
    assert torch.equal(out[1].long(), torch.argmax(bits, dim=1))
    assert torch.equal(out[2], torch.ones(B, dtype=torch.int32))


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("num_players", [1, 2])
def test_backprop_plain_matches_pallas_interpret(num_players, planar):
    tree, max_depth, spec = _jax_tree(num_players, seed=10 + num_players)
    # Real paths: this tree's next descent, one lane cut short (-1).
    got, _ = _descend_both(tree, max_depth + 1, spec)
    path_n, path_a, leaf_depth = got[3], got[4], got[2].clone()
    leaf_depth[3] = -1
    leaf_value = torch.from_numpy(np.random.default_rng(0).normal(size=B).astype(np.float32))
    src = _planar(tree) if planar else tree
    ins = [src[k] for k in ("children_visit", "children_vsum", "children_reward",
                            "root_visit", "root_vsum", "root_reward", "min_value",
                            "max_value")]
    want = mcts_pallas.backprop(
        jnp.asarray(path_n.numpy()), jnp.asarray(path_a.numpy()),
        jnp.asarray(leaf_depth.numpy()), jnp.asarray(leaf_value.numpy()),
        *(jnp.asarray(x) for x in ins), num_players=num_players,
        discount=spec.discount, interpret=True, planar=planar)
    t = [torch.from_numpy(np.array(x)) for x in ins]
    got = mcts_kernels.backprop_plain(
        path_n, path_a, leaf_depth, leaf_value, *t, num_players=num_players,
        discount=spec.discount, planar=planar)
    names = ("children_visit", "children_vsum", "root_visit", "root_vsum", "min_value",
             "max_value")
    for name, g, w in zip(names, got, want):
        if "visit" in name or num_players == 2:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=0,
                                       err_msg=name)
    # In place, as the kernel: the returned slabs are the inputs.
    assert got[0] is t[0] and got[1] is t[1]
    lanes = leaf_depth >= 0
    assert torch.equal(t[3] - torch.from_numpy(src["root_visit"]), lanes.to(torch.int32))


def _chain_case(case, planar, seed):
    """Four lanes of random slabs [B, A, N] (or node-major) and chain paths
    made with numpy: lane 0 a 40-level chain (nodes numbered in increasing
    order, as a search numbers them), lane 1 the root only, lane 2 no leaf,
    lane 3 a 9-level chain. "repeat": lane 0's path takes one edge at
    levels 6, 21 and 37 and lane 3's at levels 2 and 8, so each of those
    levels reads what a deeper one wrote."""
    rng = np.random.default_rng(seed)
    Bc, Ac, Nc, Dc = 4, 3, 48, 48
    depths = np.array([40, 0, -1, 9], np.int32)
    pn = np.full((Bc, Dc), -1, np.int32)
    pn[:, 0] = 0
    pa = np.zeros((Bc, Dc), np.int32)
    for b, L in enumerate(depths):
        if L > 0:
            pn[b, :L] = np.concatenate(([0], np.sort(rng.choice(np.arange(1, Nc), L - 1,
                                                               replace=False))))
            pa[b, :L] = rng.integers(0, Ac, L)
    if case == "repeat":
        for b, k, earlier in ((0, 20, 5), (0, 36, 5), (3, 7, 1)):
            pn[b, k], pa[b, k] = pn[b, earlier], pa[b, earlier]
    slabs = [rng.integers(0, 40, (Bc, Ac, Nc)).astype(np.int32),
             (rng.normal(size=(Bc, Ac, Nc)) * 5).astype(np.float32),
             rng.normal(size=(Bc, Ac, Nc)).astype(np.float32)]
    if not planar:
        slabs = [np.ascontiguousarray(x.transpose(0, 2, 1)) for x in slabs]
    lo = rng.normal(size=Bc).astype(np.float32) - 2
    lo[1] = np.inf  # a fresh tree's MinMaxStats
    hi = -lo
    ins = slabs + [rng.integers(0, 40, Bc).astype(np.int32),
                   (rng.normal(size=Bc) * 5).astype(np.float32),
                   rng.normal(size=Bc).astype(np.float32), lo, hi]
    leaf_value = (rng.normal(size=Bc) * 3).astype(np.float32)
    return (pn, pa, depths, leaf_value), ins


@pytest.mark.parametrize("case", ["chain", "repeat"])
@pytest.mark.parametrize("pre_marked", [False, True])
@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("num_players", [1, 2])
def test_backprop_plain_matches_pallas_interpret_on_chains(num_players, planar, pre_marked,
                                                           case):
    """backprop_plain against the JAX kernel on a 40-level chain path (the
    CUDA kernel's second chunk) and on paths that repeat an edge, in both
    layouts and both modes: the serial walk's semantics, which the kernel
    keeps. Exact with two players; with one, to RTOL and CHAIN_ATOL."""
    path, ins = _chain_case(case, planar, seed=60 + num_players)
    discount = 0.997 if num_players == 1 else 1.0
    kw = dict(num_players=num_players, discount=discount, planar=planar,
              pre_marked=pre_marked)
    # Copies: JAX on the CPU may alias a NumPy buffer that the plain
    # version then writes in place.
    want = mcts_pallas.backprop(*(jnp.asarray(x.copy()) for x in (*path, *ins)),
                                interpret=True, **kw)
    t = [torch.from_numpy(x.copy()) for x in ins]
    got = mcts_kernels.backprop_plain(*(torch.from_numpy(x) for x in path), *t, **kw)
    names = ("children_visit", "children_vsum", "root_visit", "root_vsum", "min_value",
             "max_value")
    for name, g, w in zip(names, got, want):
        if "visit" in name or num_players == 2:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=CHAIN_ATOL,
                                       err_msg=name)
    added = got[0].numpy().astype(np.int64) - ins[0]
    assert added.sum() == (0 if pre_marked else int(path[2].clip(min=0).sum()))
    if case == "repeat" and not pre_marked:
        assert added.max() == 3  # lane 0's edge, taken at three levels


def test_routing_predicates_are_the_jax_packages():
    for b, n, a in [(256, 201, 7), (64, 26, 9), (1024, 51, 2), (256, 401, 121),
                    (8, 401, 121), (96, 801, 7), (512, 201, 7), (33, 51, 3)]:
        assert mcts_kernels.fits_vmem_planar(b, n, a) == mcts_pallas.fits_vmem_planar(b, n, a)
        assert mcts_kernels.fits_vmem_backprop(b, n, a) == mcts_pallas.fits_vmem_backprop(b, n, a)
        assert mcts_kernels.choose_block_planar(b, n, a) == mcts_pallas.choose_block_planar(b, n, a)
        assert (mcts_kernels.choose_block_backprop(b, n, a)
                == mcts_pallas.choose_block_backprop(b, n, a))
    assert mcts_kernels.choose_block_planar(256, 201, 7) is not None  # connect4
    assert mcts_kernels.choose_block_planar(256, 401, 121) is None  # gomoku


def test_wrappers_take_the_plain_version_only_on_cpu():
    tree, max_depth, spec = _jax_tree(2, seed=6)
    p = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in _planar(tree).items()}
    kw = dict(num_players=2, pb_c_base=spec.pb_c_base, pb_c_init=spec.pb_c_init,
              discount=spec.discount, max_depth=SIMS)
    args = (torch.tensor(max_depth + 1, dtype=torch.int32), *(p[k] for k in SLABS),
            p["root_legal"].to(torch.int32), p["min_value"], p["max_value"])
    before = mcts_kernels.descend_planar.launches
    got = mcts_kernels.descend_planar(1, 0, *args, **kw)
    want = mcts_kernels.descend_planar_plain(1, 0, *args, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert mcts_kernels.descend_planar.launches == before  # no kernel ran
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mcts_kernels.descend_planar(1, 0, *meta, **kw)
    before = mcts_kernels.backprop.launches
    mcts_kernels.backprop(got[3], got[4], got[2], torch.zeros(B), p["children_visit"],
                          p["children_vsum"], p["children_reward"], p["root_visit"],
                          p["root_vsum"], p["root_reward"], p["min_value"],
                          p["max_value"], num_players=2, discount=1.0)
    assert mcts_kernels.backprop.launches == before


def _torch_tree(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


def _marking_round(tree, depth_bound, spec, k_sels):
    """k_sels marking descents in a row, each seeing the marks before it, on
    both sides: the JAX kernel in interpret mode (the marked slab fed on)
    and the port's plain version (in place). Returns both sides' outputs
    and the port's planar tree."""
    p = _planar(tree)
    kw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
              pb_c_init=spec.pb_c_init, discount=spec.discount, max_depth=SIMS)
    jslabs = {k: jnp.asarray(p[k]) for k in SLABS}
    t = _torch_tree(p)
    wants, gots = [], []
    for k in range(k_sels):
        want = mcts_pallas.descend_planar(
            0, depth_bound, *(jslabs[n] for n in SLABS), jnp.asarray(p["root_legal"]),
            jnp.asarray(p["min_value"]), jnp.asarray(p["max_value"]), A=A, tie_jitter=0.0,
            interpret=True, mark_visits=True, **kw)
        jslabs["children_visit"] = want[5]
        wants.append([np.asarray(w) for w in want])
        got = mcts_kernels.descend_planar_plain(
            123, k, torch.tensor(depth_bound, dtype=torch.int32), *(t[n] for n in SLABS),
            t["root_legal"].to(torch.int32), t["min_value"], t["max_value"],
            mark_visits=True, **kw)
        gots.append(got + (t["children_visit"].clone(),))  # marked in place
    return gots, wants, t


@pytest.mark.parametrize("num_players", [1, 2])
def test_marking_descend_plain_matches_pallas_interpret(num_players):
    """descend_planar_plain(mark_visits=True) against the JAX kernel's
    marking mode, over one round of four selections: every output and the
    marked visit slab exact, the marks in place, one per edge taken."""
    tree, max_depth, spec = _jax_tree(num_players, seed=20 + num_players)
    before = torch.from_numpy(np.ascontiguousarray(_planar(tree)["children_visit"]))
    gots, wants, t = _marking_round(tree, max_depth + 1, spec, 4)
    names = ("parent", "action", "leaf_depth", "path_n", "path_a", "marked_visit")
    for got, want in zip(gots, wants):
        for name, g, w in zip(names, got, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    marks = int((t["children_visit"] - before).sum())
    assert marks == sum(int(g[2].sum()) for g in gots)
    # The marks steer: a round's selections do not all repeat the first.
    assert any(not torch.equal(g[4], gots[0][4]) for g in gots[1:])


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("num_players", [1, 2])
def test_pre_marked_backprop_plain_matches_pallas_interpret(num_players, planar):
    """backprop_plain(pre_marked=True) against the JAX kernel's pre-marked
    mode, the round's four paths folded one after another into the marked
    tree: no visit added, value sums and min/max as the kernel (to RTOL with
    one player, see the module docstring; each step then goes on from the
    JAX side's tensors, so that the rounding of one step is not carried
    into the next)."""
    tree, max_depth, spec = _jax_tree(num_players, seed=30 + num_players)
    gots, _, t = _marking_round(tree, max_depth + 1, spec, 4)
    t["root_visit"] += 4  # the round's root marks, outside the kernel
    if not planar:
        t = {k: (v.transpose(1, 2).contiguous() if k in SLABS else v) for k, v in t.items()}
    names = ("children_visit", "children_vsum", "root_visit", "root_vsum", "min_value",
             "max_value")
    ins = [t[n] for n in ("children_visit", "children_vsum", "children_reward", "root_visit",
                          "root_vsum", "root_reward", "min_value", "max_value")]
    # Copies: JAX on the CPU may alias a NumPy buffer, and its dispatch is
    # asynchronous, so the in-place plain backprop below would race the
    # kernel's reads of its inputs.
    jins = [jnp.asarray(x.numpy().copy()) for x in ins]
    visits = ins[0].clone(), ins[3].clone()
    rng = np.random.default_rng(num_players)
    for got in gots:
        path_n, path_a, leaf_depth = got[3], got[4], got[2]
        leaf_value = torch.from_numpy(rng.normal(size=B).astype(np.float32))
        out = mcts_pallas.backprop(
            jnp.asarray(path_n.numpy()), jnp.asarray(path_a.numpy()),
            jnp.asarray(leaf_depth.numpy()), jnp.asarray(leaf_value.numpy()), *jins,
            num_players=num_players, discount=spec.discount, interpret=True,
            planar=planar, pre_marked=True)
        jins[0], jins[1], jins[3], jins[4], jins[6], jins[7] = out
        mcts_kernels.backprop_plain(path_n, path_a, leaf_depth, leaf_value, *ins,
                                    num_players=num_players, discount=spec.discount,
                                    planar=planar, pre_marked=True)
        for name, i in zip(names, (0, 1, 3, 4, 6, 7)):
            w = np.asarray(jins[i])
            if "visit" in name or num_players == 2:
                np.testing.assert_array_equal(ins[i].numpy(), w, err_msg=name)
            else:
                np.testing.assert_allclose(ins[i].numpy(), w, rtol=RTOL, atol=0,
                                           err_msg=name)
            ins[i].copy_(torch.from_numpy(w.copy()))
    assert torch.equal(ins[0], visits[0]) and torch.equal(ins[3], visits[1])


@pytest.mark.parametrize("bound", ["tree", 2])
@pytest.mark.parametrize("num_players", [1, 2])
def test_node_major_descend_plain_matches_pallas_interpret(num_players, bound):
    """descend_plain (node-major [B, N, A]) against mcts_pallas.descend in
    interpret mode, exact; and against the planar plain descent on the same
    tree with tie jitter on, bit for bit."""
    tree, max_depth, spec = _jax_tree(num_players, seed=40 + num_players)
    depth_bound = max_depth + 1 if bound == "tree" else bound
    kw = dict(num_players=num_players, pb_c_base=spec.pb_c_base, pb_c_init=spec.pb_c_init,
              discount=spec.discount, max_depth=SIMS)
    want = mcts_pallas.descend(
        0, depth_bound, *(jnp.asarray(tree[k]) for k in SLABS),
        jnp.asarray(tree["root_legal"]), jnp.asarray(tree["min_value"]),
        jnp.asarray(tree["max_value"]), A=A, tie_jitter=0.0, interpret=True, **kw)
    t = _torch_tree(tree)
    args = (torch.tensor(depth_bound, dtype=torch.int32), *(t[k] for k in SLABS),
            t["root_legal"].to(torch.int32), t["min_value"], t["max_value"])
    got = mcts_kernels.descend_plain(5, 9, *args, **kw)
    for name, g, w in zip(("parent", "action", "leaf_depth", "path_n", "path_a"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if bound == 2:
        assert bool((got[2] == -1).any())
    p = _torch_tree(_planar(tree))
    pargs = (args[0], *(p[k] for k in SLABS), *args[6:])
    for jitter in (0.0, 1e-5):
        node_major = mcts_kernels.descend(5, 9, *args, tie_jitter=jitter, **kw)
        planar = mcts_kernels.descend_planar(5, 9, *pargs, tie_jitter=jitter, **kw)
        for g, w in zip(node_major, planar):
            assert torch.equal(g, w)
