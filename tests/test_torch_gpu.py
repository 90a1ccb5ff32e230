"""The CUDA kernels against their plain PyTorch versions, on the card: the
fused search (ops/mcts_fused.py), the staged search's descents (planar, with
and without the virtual-visit mark, and node-major) and backprop (with and
without pre-marked visits; ops/mcts_kernels.py), the streaming search's
descent and edge updates (ops/mcts_stream.py), the hidden-store row write
(ops/hidden_store.py), and the probes' convolutions and pointer chase
(tools/conv_probe.py, tools/stream_probe.py, held to tolerances stated
there); and the bf16 ResNet on the card against itself on the CPU.

Every test here carries the `gpu` marker and skips without a CUDA card. The
file imports no JAX, so it also runs where JAX is absent; there the suite's
conftest (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Kernel and plain version get the same card tensors and run the same float32
operations in the same order, with the same Philox tie jitter when it is on,
so visit counts and depth must be equal and root values agree to 1e-5; the
tree kernels' outputs (paths, visits, value sums, min/max) are equal, and so
are the stream kernels' (every descend output, every live slab row).
"""

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
import torch

from muzero_general_tpu_torch.config import MuZeroConfig as BaseConfig
from muzero_general_tpu_torch.games import connect4, gomoku
from muzero_general_tpu_torch.games.cartpole import MuZeroConfig, make_env
from muzero_general_tpu_torch.models import MuZeroNetwork, fold_bn
from muzero_general_tpu_torch.ops import mcts as mcts_ops
from muzero_general_tpu_torch.ops import mcts_fused, mcts_kernels, mcts_stream
from muzero_general_tpu_torch.selfplay import SelfPlayDriver

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cfg, B, num_players, noise, seed, dev):
    net = MuZeroNetwork(cfg, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = len(cfg.action_space)
    obs = torch.randn((B,) + tuple(cfg.observation_shape), generator=gen, device=dev)
    legal = torch.rand((B, A), generator=gen, device=dev) < 0.7
    legal[:, 0] = True
    to_play = (torch.arange(B, device=dev) % num_players).to(torch.int32)
    spec = mcts_fused.FusedSpec.from_config(cfg, deterministic_tie_break=True)
    with torch.no_grad():
        root = mcts_fused.prepare_root(net, obs, legal, to_play, gen, spec, noise)
    weights = mcts_fused.fused_weights(net, cfg.encoding_size)
    args = (root.prior, root.hidden, root.reward, root.to_play, root.legal, weights)
    return args, mcts_fused.search_kwargs(spec), legal


def _check_equal(args, kw, legal, sims):
    before = mcts_fused.search.launches
    visits, value, depth = mcts_fused.search(*args, **kw)
    p_visits, p_value, p_depth = mcts_fused.search_plain(*args, **kw)
    torch.cuda.synchronize()
    assert mcts_fused.search.launches == before + 1
    assert torch.equal(visits, p_visits)
    assert torch.equal(depth, p_depth)
    torch.testing.assert_close(value, p_value, rtol=0, atol=1e-5)
    assert bool((visits.sum(1) == sims).all())
    assert not bool(visits[~legal].any())


@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("noise", [False, True])
def test_kernel_matches_plain_cartpole_shapes(cuda, num_players, noise):
    cfg = MuZeroConfig()
    cfg.players = list(range(num_players))
    args, kw, legal = _inputs(cfg, 64, num_players, noise, 0, cuda)
    _check_equal(args, kw, legal, cfg.num_simulations)


def test_kernel_deeper_dynamics_mlp(cuda):
    cfg = MuZeroConfig()
    cfg.num_simulations = 12
    cfg.encoding_size = 6
    cfg.fc_dynamics_layers = [16, 12]
    cfg.fc_reward_layers = []
    cfg.fc_value_layers = [8]
    cfg.fc_policy_layers = [8]
    args, kw, legal = _inputs(cfg, 40, 1, True, 1, cuda)
    _check_equal(args, kw, legal, cfg.num_simulations)


@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
def test_kernel_lunarlander_widths(cuda, tie_jitter):
    cfg = BaseConfig()
    cfg.observation_shape = (1, 1, 8)
    cfg.action_space = list(range(4))
    cfg.encoding_size = 10
    cfg.fc_dynamics_layers = cfg.fc_reward_layers = [64]
    cfg.fc_value_layers = cfg.fc_policy_layers = [64]
    args, kw, legal = _inputs(cfg, 37, 1, True, 2, cuda)
    kw = kw | {"tie_jitter": tie_jitter, "seed": 5}
    _check_equal(args, kw, legal, cfg.num_simulations)


@pytest.mark.parametrize("num_players", [1, 2])
def test_kernel_tie_jitter(cuda, num_players):
    """With tie jitter on, kernel and plain version add the same Philox
    stream, so they still agree exactly; the stream is keyed by the seed."""
    cfg = MuZeroConfig()
    cfg.players = list(range(num_players))
    args, kw, legal = _inputs(cfg, 64, num_players, True, 3, cuda)
    kw = kw | {"tie_jitter": 1e-5, "seed": (1 << 40) + 11}
    _check_equal(args, kw, legal, cfg.num_simulations)
    a = mcts_fused.search(*args, **kw)
    b = mcts_fused.search(*args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_rejects_bad_inputs(cuda):
    args, kw, _ = _inputs(MuZeroConfig(), 8, 1, False, 4, cuda)
    with pytest.raises(ValueError, match="dtype"):
        mcts_fused.search(*args[:4], args[4].to(torch.int64), args[5], **kw)
    with pytest.raises(ValueError, match="on cpu"):
        mcts_fused.search(args[0], args[1].cpu(), *args[2:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        prior = args[0].t().contiguous().t()
        mcts_fused.search(prior, *args[1:], **kw)


def test_selfplay_runs_through_the_kernel(cuda):
    cfg = MuZeroConfig()
    cfg.parallel_games = 32
    cfg.num_simulations = 16
    cfg.selfplay_chunk_moves = 5
    driver = SelfPlayDriver(make_env(), MuZeroNetwork(cfg), cfg, seed=0)
    before = mcts_fused.search.launches
    _, stats = driver.play(temperature=1.0)
    assert mcts_fused.search.launches == before + 5
    assert stats["env_steps"] == 160 and stats["max_tree_depth"] >= 1


@pytest.mark.parametrize("support_size", [10, 20])
def test_kernel_support_sizes(cuda, support_size):
    """Supports of 21 and 41 logits (more than a warp's threads), tie jitter
    on: the decodes run across the group and sum from index 0 on one thread,
    so the kernel still matches search_plain."""
    cfg = MuZeroConfig()
    cfg.support_size = support_size
    args, kw, legal = _inputs(cfg, 48, 1, True, 6, cuda)
    _check_equal(args, kw | {"tie_jitter": 1e-5, "seed": 21}, legal, cfg.num_simulations)


@pytest.mark.parametrize("num_players", [1, 2])
def test_kernel_layers_wider_than_a_warp(cuda, num_players):
    """A net whose layers are 48 and 40 wide (one lane a warp), two hidden
    layers in two of the heads (their passes run together), tie jitter on."""
    cfg = BaseConfig()
    cfg.observation_shape = (1, 1, 6)
    cfg.action_space = list(range(5))
    cfg.players = list(range(num_players))
    cfg.encoding_size = 12
    cfg.fc_dynamics_layers = [48]
    cfg.fc_reward_layers = [40, 24]
    cfg.fc_value_layers = [48]
    cfg.fc_policy_layers = [40, 33]
    args, kw, legal = _inputs(cfg, 41, num_players, True, 7, cuda)
    _check_equal(args, kw | {"tie_jitter": 1e-5, "seed": 9}, legal, cfg.num_simulations)


@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
def test_kernel_one_action(cuda, tie_jitter):
    """A = 1: every descent takes action 0 to the leaf, the root's visits are
    the simulations."""
    cfg = MuZeroConfig()
    cfg.action_space = [0]
    args, kw, legal = _inputs(cfg, 24, 1, True, 8, cuda)
    _check_equal(args, kw | {"tie_jitter": tie_jitter, "seed": 3}, legal,
                 cfg.num_simulations)


def test_kernel_400_simulations(cuda):
    """400 simulations: the numerator and reciprocal tables reach 402
    entries, the trees are deep, and two lanes' trees no longer fit a
    two-lanes-a-warp block, so the kernel takes one lane a warp; tie jitter
    on."""
    cfg = MuZeroConfig()
    cfg.num_simulations = 400
    args, kw, legal = _inputs(cfg, 12, 1, True, 9, cuda)
    _check_equal(args, kw | {"tie_jitter": 1e-5, "seed": 5}, legal, cfg.num_simulations)


# ---- the staged search's tree kernels --------------------------------------


def _tree(dev, num_players, B=64, sims=40, seed=0):
    """A real connect4-shaped tree (1 x 16 ResNet, random init) after `sims`
    of 2 * sims simulations, planar, with the search's spec and inputs."""
    cfg = connect4.MuZeroConfig()
    cfg.blocks, cfg.channels = 1, 16
    cfg.num_simulations = 2 * sims
    cfg.players = list(range(num_players))
    cfg.use_pallas_mcts = True
    net = fold_bn(MuZeroNetwork(cfg, device=dev, seed=seed))
    env = connect4.make_env(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = env.reset(B, gen)
    for _ in range(4):
        state, _, _ = env.step(state, env.random_legal_action(state, gen), gen)
    spec = mcts_ops.SearchSpec.from_config(cfg, B, dev)
    legal = env.legal_actions_mask(state)
    with torch.no_grad():
        out = mcts_ops.run_mcts(net.initial_inference, net.recurrent_inference,
                                env.observation(state), legal, env.to_play(state), gen,
                                spec, seed=seed, num_steps=sims)
    bound = (out.max_tree_depth.max() + 1).to(torch.int32)
    return mcts_ops._to_planar(out.tree), spec, legal.to(torch.int32), bound, sims


def _descend_args(tree, spec, legal, bound, sim, seed, tie_jitter):
    args = (seed, sim, bound, tree.children_index, tree.children_prior,
            tree.children_visit, tree.children_vsum, tree.children_reward, legal,
            tree.min_value, tree.max_value)
    kw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
              pb_c_init=spec.pb_c_init, discount=spec.discount,
              max_depth=spec.max_depth, tie_jitter=tie_jitter)
    return args, kw


@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
def test_descend_kernel_matches_plain(cuda, num_players, tie_jitter):
    tree, spec, legal, bound, sim = _tree(cuda, num_players)
    args, kw = _descend_args(tree, spec, legal, bound, sim, (1 << 35) + 3, tie_jitter)
    before = mcts_kernels.descend_planar.launches
    got = mcts_kernels.descend_planar(*args, **kw)
    want = mcts_kernels.descend_planar_plain(*args, **kw)
    torch.cuda.synchronize()
    assert mcts_kernels.descend_planar.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2].min()) >= 1
    # A bound too small for the tree marks the cut lanes -1, as the plain one.
    args = args[:2] + (torch.tensor(1, dtype=torch.int32, device=cuda),) + args[3:]
    got = mcts_kernels.descend_planar(*args, **kw)
    want = mcts_kernels.descend_planar_plain(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[2] == -1).any())


@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
def test_descend_kernel_breaks_exact_ties_as_plain(cuda, tie_jitter):
    """A fresh root whose legal actions all score the same: without jitter
    the first legal index wins, with it the Philox stream decides; the
    kernel picks as the plain version does either way."""
    B, A, N = 96, 7, 9
    i32 = dict(dtype=torch.int32, device=cuda)
    idx = torch.full((B, A, N), -1, **i32)
    prior = torch.full((B, A, N), 1.0 / A, device=cuda)
    zeros_i, zeros_f = torch.zeros((B, A, N), **i32), torch.zeros((B, A, N), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    legal = (torch.rand((B, A), generator=gen, device=cuda) < 0.6).to(torch.int32)
    legal[:, A - 1] = 1
    inf = torch.full((B,), float("inf"), device=cuda)
    args = (7, 2, torch.tensor(3, **i32), idx, prior, zeros_i, zeros_f, zeros_f, legal,
            inf, -inf)
    kw = dict(num_players=2, pb_c_base=19652.0, pb_c_init=1.25, discount=1.0,
              max_depth=N - 1, tie_jitter=tie_jitter)
    got = mcts_kernels.descend_planar(*args, **kw)
    want = mcts_kernels.descend_planar_plain(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if tie_jitter == 0.0:
        assert torch.equal(got[1].long(), torch.argmax(legal, dim=1))


@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("planar", [True, False])
def test_backprop_kernel_matches_plain(cuda, num_players, planar):
    tree, spec, legal, bound, sim = _tree(cuda, num_players, seed=1)
    args, kw = _descend_args(tree, spec, legal, bound, sim, 5, 1e-5)
    _, _, leaf_depth, path_n, path_a = mcts_kernels.descend_planar(*args, **kw)
    leaf_depth[::7] = -1  # lanes the bound cut: nothing to back up
    if not planar:
        tree = mcts_ops._from_planar(tree)
    gen = torch.Generator(device=cuda).manual_seed(2)
    leaf_value = torch.randn(leaf_depth.shape, generator=gen, device=cuda)
    outs = []
    for fn in (mcts_kernels.backprop, mcts_kernels.backprop_plain):
        t = mcts_ops.Tree(*(x.clone() for x in tree))
        outs.append(fn(path_n, path_a, leaf_depth, leaf_value, t.children_visit,
                       t.children_vsum, t.children_reward, t.root_visit, t.root_vsum,
                       t.root_reward, t.min_value, t.max_value,
                       num_players=num_players, discount=spec.discount, planar=planar))
    torch.cuda.synchronize()
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    assert torch.equal(outs[0][2] - tree.root_visit, (leaf_depth >= 0).to(torch.int32))


def test_tree_kernels_reject_bad_inputs(cuda):
    tree, spec, legal, bound, sim = _tree(cuda, 2, B=8, sims=6)
    args, kw = _descend_args(tree, spec, legal, bound, sim, 0, 0.0)
    with pytest.raises(ValueError, match="dtype"):
        mcts_kernels.descend_planar(*args[:8], legal.bool(), *args[9:], **kw)
    with pytest.raises(ValueError, match="depth_bound"):
        mcts_kernels.descend_planar(*args[:2], int(bound), *args[3:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        prior = tree.children_prior.transpose(1, 2).contiguous().transpose(1, 2)
        mcts_kernels.descend_planar(*args[:4], prior, *args[5:], **kw)
    _, _, depth, path_n, path_a = mcts_kernels.descend_planar(*args, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        mcts_kernels.backprop(path_n, path_a, depth, torch.zeros(8), tree.children_visit,
                              tree.children_vsum, tree.children_reward, tree.root_visit,
                              tree.root_vsum, tree.root_reward, tree.min_value,
                              tree.max_value, num_players=2, discount=1.0)


def _marking_round(tree, spec, legal, bound, sim, seed, tie_jitter, fn, k_sels=4):
    """k_sels marking descents in a row on a copy of the visit slab (the
    round's simulations sim .. sim + k_sels - 1); returns the outputs, the
    marked slab cloned after each."""
    t = tree._replace(children_visit=tree.children_visit.clone())
    outs = []
    for k in range(k_sels):
        args, kw = _descend_args(t, spec, legal, bound, sim + k, seed, tie_jitter)
        out = fn(*args, mark_visits=True, **kw)
        outs.append(out + (t.children_visit.clone(),))
    return outs, t


@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
def test_marking_descend_kernel_matches_plain(cuda, num_players, tie_jitter):
    tree, spec, legal, bound, sim = _tree(cuda, num_players, seed=3)
    before = (mcts_kernels.descend_planar.launches, mcts_kernels.descend_planar.marked_launches)
    got, k_tree = _marking_round(tree, spec, legal, bound, sim, 11, tie_jitter,
                                 mcts_kernels.descend_planar)
    want, _ = _marking_round(tree, spec, legal, bound, sim, 11, tie_jitter,
                             mcts_kernels.descend_planar_plain)
    torch.cuda.synchronize()
    after = (mcts_kernels.descend_planar.launches, mcts_kernels.descend_planar.marked_launches)
    assert after == (before[0] + 4, before[1] + 4)
    for g_out, w_out in zip(got, want):
        for g, w in zip(g_out, w_out):
            assert torch.equal(g, w)
    marks = int((k_tree.children_visit - tree.children_visit).sum())
    assert marks == sum(int(g[2].sum()) for g in got)


@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("planar", [True, False])
def test_pre_marked_backprop_kernel_matches_plain(cuda, num_players, planar):
    """A round's four paths, folded one after another into the marked tree:
    the kernel and the plain version agree exactly, and no visit is added."""
    tree, spec, legal, bound, sim = _tree(cuda, num_players, seed=4)
    sels, marked = _marking_round(tree, spec, legal, bound, sim, 6, 1e-5,
                                  mcts_kernels.descend_planar)
    marked = marked._replace(root_visit=marked.root_visit + 4)
    if not planar:
        marked = mcts_ops._from_planar(marked)
    gen = torch.Generator(device=cuda).manual_seed(5)
    values = [torch.randn((tree.root_visit.shape[0],), generator=gen, device=cuda)
              for _ in sels]
    before = (mcts_kernels.backprop.launches, mcts_kernels.backprop.pre_marked_launches)
    outs = []
    for fn in (mcts_kernels.backprop, mcts_kernels.backprop_plain):
        t = mcts_ops.Tree(*(x.clone() for x in marked))
        for sel, value in zip(sels, values):
            out = fn(sel[3], sel[4], sel[2], value, t.children_visit, t.children_vsum,
                     t.children_reward, t.root_visit, t.root_vsum, t.root_reward,
                     t.min_value, t.max_value, num_players=num_players,
                     discount=spec.discount, planar=planar, pre_marked=True)
        outs.append(out)
    torch.cuda.synchronize()
    after = (mcts_kernels.backprop.launches, mcts_kernels.backprop.pre_marked_launches)
    assert after == (before[0] + 4, before[1] + 4)
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    assert torch.equal(outs[0][0], marked.children_visit)
    assert torch.equal(outs[0][2], marked.root_visit)


_BP_OUTS = ("children_visit", "children_vsum", "root_visit", "root_vsum", "min_value",
            "max_value")


def _chain_slabs(dev, B, A, N, D, depths, seed, planar, zeros=False, repeats=()):
    """Random slabs and chain paths, made with numpy from `seed`: lane b's
    path runs from the root through depths[b] - 1 more nodes, numbered in
    increasing order as a search numbers them, taking random actions
    (depth -1: no leaf; padding as a descent leaves it). Visit counts,
    value sums, rewards, leaf values and root stats are random; with
    `zeros` every one of them is a zero of random sign (visits stay
    counts), so that each stat is exactly +0 or -0. `repeats` lists (lane,
    entry, earlier entry): the entry takes the earlier one's edge.
    Returns (path_n, path_a, leaf_depth, leaf_value) and the eight slab and
    root tensors in backprop's argument order."""
    rng = np.random.default_rng(seed)
    pn = np.full((B, D), -1, np.int32)
    pn[:, 0] = 0  # the root, on every lane
    pa = np.zeros((B, D), np.int32)
    for b, L in enumerate(depths):
        if L > 0:
            pn[b, :L] = np.concatenate(([0], np.sort(rng.choice(np.arange(1, N), L - 1,
                                                               replace=False))))
            pa[b, :L] = rng.integers(0, A, L)
    for b, k, earlier in repeats:
        pn[b, k], pa[b, k] = pn[b, earlier], pa[b, earlier]

    def value(*shape):
        if zeros:
            return np.where(rng.random(shape) < 0.5, -0.0, 0.0).astype(np.float32)
        return (rng.normal(size=shape) * 3).astype(np.float32)

    visit = rng.integers(0, 40, (B, A, N)).astype(np.int32)
    vsum, reward = value(B, A, N), value(B, A, N)
    if not planar:
        visit, vsum, reward = (np.ascontiguousarray(x.transpose(0, 2, 1))
                               for x in (visit, vsum, reward))
    lo, hi = value(B), value(B)
    if not zeros:
        lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
        lo[::5], hi[::5] = np.inf, -np.inf  # a fresh tree's MinMaxStats
    slabs = (visit, vsum, reward, rng.integers(0, 40, B).astype(np.int32), value(B), value(B),
             lo, hi)
    path = (pn, pa, np.asarray(depths, np.int32), value(B))
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return tuple(map(to, path)), tuple(map(to, slabs))


def _assert_backprops_equal(paths, slabs, **kw):
    """The kernel and the plain version fold `paths` one after another into
    copies of `slabs`: all six outputs bit for bit (floats compared as
    int32, so that signed zeros count). Returns the kernel's outputs."""
    outs = []
    for fn in (mcts_kernels.backprop, mcts_kernels.backprop_plain):
        t = [x.clone() for x in slabs]
        for path in paths:
            out = fn(*path, *t, **kw)
        outs.append(out)
    torch.cuda.synchronize()
    for name, g, w in zip(_BP_OUTS, *outs):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
    return outs[0]


def _bp_kw(num_players, planar, pre_marked):
    return dict(num_players=num_players, discount=0.997 if num_players == 1 else 1.0,
                planar=planar, pre_marked=pre_marked)


_A, _N, _D = 7, 240, 201  # connect4's actions and depth bound, a tree's worth of nodes
# Leaf depths of the chain slab's 16 lanes: in the first chunk of 32 and
# past it (a lane at D - 1 = 200 runs seven chunks), no leaf, the root.
_CHAIN_DEPTHS = [33, 64, 200, -1, 0, 1, 2, 12, 31, 32, 63, 65, 96, 97, 150, 5]


@pytest.mark.parametrize("pre_marked", [False, True])
@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("case", ["chains", "repeats", "zeros"])
def test_backprop_kernel_matches_plain_on_chain_slabs(cuda, case, num_players, planar,
                                                      pre_marked):
    """Chain paths 1 to 200 levels deep (chunks of 32 and their edges),
    lanes with no leaf and at the root; paths that repeat an edge inside a
    chunk and across chunks (each level must read what a deeper one wrote);
    and stats that are exactly +0 or -0 (the min/max's signed zeros): the
    kernel equals the plain version bit for bit."""
    repeats = ()
    if case == "repeats":
        # lane 7 (12 levels) inside its chunk; lane 0 (33) across chunks;
        # lane 2 (200) inside a deep chunk and across several; lane 13 (97)
        # twice on one edge.
        repeats = ((7, 9, 3), (0, 32, 4), (2, 150, 140), (2, 199, 20), (13, 60, 10),
                   (13, 90, 10))
    paths, slabs = _chain_slabs(cuda, 16, _A, _N, _D, _CHAIN_DEPTHS, 7, planar,
                                zeros=case == "zeros", repeats=repeats)
    out = _assert_backprops_equal([paths], slabs, **_bp_kw(num_players, planar, pre_marked))
    if case == "zeros":
        stats = torch.cat([out[4], out[5]])
        assert bool((stats == 0).all()) and bool(torch.signbit(stats).any())
        assert not bool(torch.signbit(stats).all())


@pytest.mark.parametrize("pre_marked", [False, True])
@pytest.mark.parametrize("B", [1, 7, 256, 1000])
def test_backprop_kernel_matches_plain_at_lane_counts(cuda, B, pre_marked):
    """One lane to 1,000 lanes (blocks and warps past the last lane), depths
    from -1 to 40 and the first and second chunk's edges."""
    rng = np.random.default_rng(B)
    depths = rng.integers(-1, 41, B).tolist()
    for num_players in (1, 2):
        paths, slabs = _chain_slabs(cuda, B, _A, 64, 48, depths, B + num_players, True)
        _assert_backprops_equal([paths], slabs, **_bp_kw(num_players, True, pre_marked))


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("num_players", [1, 2])
def test_pre_marked_backprop_kernel_folds_a_round_of_eight(cuda, num_players, planar):
    """A multi-leaf round's 8 pre-marked backprops, one after another, on
    paths that share their edges as a round's duplicate selections do (each
    lane's 8 paths are prefixes of one chain, 1 to 40 levels): value sums,
    root stats and min/max bit for bit, no visit added."""
    B = 64
    rng = np.random.default_rng(num_players)
    full, slabs = _chain_slabs(cuda, B, _A, 64, 48, [40] * B, 3, planar)
    paths = []
    for k in range(8):
        depth = torch.from_numpy(rng.integers(1, 41, B).astype(np.int32)).to(cuda)
        keep = torch.arange(48, device=cuda)[None, :] < depth[:, None]
        leaf = torch.from_numpy(rng.normal(size=B).astype(np.float32)).to(cuda)
        paths.append((torch.where(keep, full[0], -1), torch.where(keep, full[1], 0), depth,
                      leaf))
    before = mcts_kernels.backprop.pre_marked_launches
    out = _assert_backprops_equal(paths, slabs, **_bp_kw(num_players, planar, True))
    assert mcts_kernels.backprop.pre_marked_launches == before + 8
    assert torch.equal(out[0], slabs[0]) and torch.equal(out[2], slabs[3])


@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
def test_node_major_descend_kernel_matches_plain_and_planar(cuda, num_players, tie_jitter):
    tree, spec, legal, bound, sim = _tree(cuda, num_players, seed=5)
    node_major = mcts_ops._from_planar(tree)
    args, kw = _descend_args(node_major, spec, legal, bound, sim, (1 << 33) + 9, tie_jitter)
    before = mcts_kernels.descend.launches
    got = mcts_kernels.descend(*args, **kw)
    want = mcts_kernels.descend_plain(*args, **kw)
    p_args, _ = _descend_args(tree, spec, legal, bound, sim, (1 << 33) + 9, tie_jitter)
    planar = mcts_kernels.descend_planar(*p_args, **kw)
    torch.cuda.synchronize()
    assert mcts_kernels.descend.launches == before + 1
    for g, w, p in zip(got, want, planar):
        assert torch.equal(g, w) and torch.equal(g, p)
    assert int(got[2].min()) >= 1
    cut = args[:2] + (torch.tensor(1, dtype=torch.int32, device=cuda),) + args[3:]
    for g, w in zip(mcts_kernels.descend(*cut, **kw), mcts_kernels.descend_plain(*cut, **kw)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="shape"):
        mcts_kernels.descend(*args[:3], tree.children_index, *args[4:], **kw)


class _PlanarTree(NamedTuple):
    """The planar slabs and MinMaxStats a descent reads."""

    children_index: torch.Tensor
    children_prior: torch.Tensor
    children_visit: torch.Tensor
    children_vsum: torch.Tensor
    children_reward: torch.Tensor
    min_value: torch.Tensor
    max_value: torch.Tensor


def _random_planar_tree(dev, B, A, N, seed, max_visit=7):
    """Random planar [B, A, N] slabs, not a search's: visit counts 1 to
    max_visit on 10% of the edges (half of them at A = 1), value sums from 1e-38 to 1e30 in
    magnitude (below 2^-100 the kernel's quotients take the IEEE division),
    random priors and rewards, child links to random nodes (cycles included:
    the bound cuts them) on visited edges; a random legal mask with one
    legal action at least, and min/max values."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    visited = rand(B, A, N) < (0.5 if A == 1 else 0.1)
    visit = torch.where(visited, torch.floor(rand(B, A, N) * max_visit) + 1, 0.0)
    scale = torch.pow(10.0, rand(B, A, N) * 68 - 38)
    vsum = (rand(B, A, N) * 2 - 1) * scale * visited
    child = torch.where(visited, torch.floor(rand(B, A, N) * (N - 1)) + 1, -1.0)
    legal = (rand(B, A) < 0.8).to(torch.int32)
    legal[torch.arange(B, device=dev), torch.randint(0, A, (B,), generator=gen, device=dev)] = 1
    lo = -rand(B)
    tree = _PlanarTree(child.to(torch.int32), rand(B, A, N) / A, visit.to(torch.int32), vsum,
                       rand(B, A, N) * 2 - 1, lo, lo + 2)
    return tree, legal


def _assert_planar_descents_equal(tree, legal, bound, spec, mark_visits, seed=3, sim=9):
    """descend_planar and its plain version on copies of the visit slab: all
    five outputs and (mark_visits) the marked slab equal."""
    outs = []
    for fn in (mcts_kernels.descend_planar, mcts_kernels.descend_planar_plain):
        t = tree._replace(children_visit=tree.children_visit.clone())
        args, kw = _descend_args(t, spec, legal, bound, sim, seed, spec.tie_jitter)
        outs.append(fn(*args, mark_visits=mark_visits, **kw) + (t.children_visit,))
    torch.cuda.synchronize()
    for name, g, w in zip(("parent", "action", "leaf_depth", "path_nodes", "path_actions",
                           "visits"), *outs):
        assert torch.equal(g, w), name
    return outs[0]


def _planar_spec(N, num_players, tie_jitter):
    return SimpleNamespace(num_players=num_players, pb_c_base=19652.0, pb_c_init=1.25,
                           discount=0.97 if num_players == 1 else 1.0, max_depth=N - 1,
                           tie_jitter=tie_jitter)


@pytest.mark.parametrize("mark_visits", [False, True], ids=["descend", "mark"])
@pytest.mark.parametrize("A", [1, 7, 32, 33, 40])
def test_descend_planar_kernel_matches_plain_on_random_rows(cuda, A, mark_visits):
    """Random rows of N = 401 nodes, A = 1 to 40 actions (above 32 the kernel
    reads a level in two passes): all outputs and the marked slab equal,
    without and with tie jitter, one and two players; then with a bound of
    2, which cuts lanes."""
    B, N = 64, 401
    tree, legal = _random_planar_tree(cuda, B, A, N, seed=A + 100 * mark_visits)
    bound = torch.tensor(40, dtype=torch.int32, device=cuda)
    for num_players, jitter in ((1, 0.0), (2, 1e-5)):
        kw = _planar_spec(N, num_players, jitter)
        got = _assert_planar_descents_equal(tree, legal, bound, kw, mark_visits)
        assert bool((got[3][:, 2] >= 0).any())  # some lane went two levels down
    cut = torch.tensor(2, dtype=torch.int32, device=cuda)
    got = _assert_planar_descents_equal(tree, legal, cut, _planar_spec(N, 2, 1e-5),
                                        mark_visits)
    assert bool((got[2] == -1).any())


@pytest.mark.parametrize("mark_visits", [False, True], ids=["descend", "mark"])
@pytest.mark.parametrize("A", [7, 40])
def test_descend_planar_kernel_past_its_tables(cuda, A, mark_visits):
    """Nine nodes whose edges carry up to 60 visits: parent visit counts pass
    the kernel's numerator table (N + 2 entries) and the divisors its
    reciprocal table, so it computes the numerator and divides in IEEE
    there; all outputs equal."""
    B, N = 64, 9
    tree, legal = _random_planar_tree(cuda, B, A, N, seed=7 + A, max_visit=60)
    tree = tree._replace(children_visit=torch.where(
        tree.children_visit > 0, tree.children_visit, 0).contiguous())
    assert int(tree.children_visit.sum((1, 2)).max()) > N + 2
    bound = torch.tensor(N - 1, dtype=torch.int32, device=cuda)
    for num_players, jitter in ((1, 0.0), (2, 1e-5)):
        _assert_planar_descents_equal(tree, legal, bound, _planar_spec(N, num_players, jitter),
                                      mark_visits)


@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
@pytest.mark.parametrize("A", [1, 7, 32, 33, 40])
def test_descend_planar_kernel_breaks_ties_at_every_width(cuda, A, tie_jitter):
    """All-tied fresh roots (equal priors, no visits), both modes: without
    jitter the first legal action wins, with it the Philox stream decides,
    as in the plain version."""
    B, N = 96, 9
    i32 = dict(dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(A)
    legal = (torch.rand((B, A), generator=gen, device=cuda) < 0.6).to(torch.int32)
    legal[:, A - 1] = 1
    inf = torch.full((B,), float("inf"), device=cuda)
    zeros = torch.zeros((B, A, N), device=cuda)
    tree = _PlanarTree(torch.full((B, A, N), -1, **i32), torch.full((B, A, N), 1.0 / A,
                                                                    device=cuda),
                       torch.zeros((B, A, N), **i32), zeros, zeros, inf, -inf)
    bound = torch.tensor(3, **i32)
    for mark_visits in (False, True):
        got = _assert_planar_descents_equal(tree, legal, bound,
                                            _planar_spec(N, 2, tie_jitter), mark_visits)
        if tie_jitter == 0.0:
            assert torch.equal(got[1].long(), torch.argmax(legal, dim=1))


@pytest.mark.parametrize("dtype, rest", [(torch.float32, (64, 6, 7)),
                                         (torch.float32, (3,)),
                                         (torch.float16, (3,))])
def test_row_write_kernel_matches_plain(cuda, dtype, rest):
    """Rows 16-byte aligned (the uint4 path), 4-byte aligned and 2-byte
    aligned (the narrower copies): bit-equal to the plain version, every
    other row untouched; a node out of range writes nothing."""
    from muzero_general_tpu_torch.ops import hidden_store

    N, B = 9, 5
    gen = torch.Generator(device=cuda).manual_seed(6)
    store = torch.randn((N, B) + rest, generator=gen, device=cuda).to(dtype)
    leaf = torch.randn((B,) + rest, generator=gen, device=cuda)
    for node in (0, 3, 5, N - 1, N, -1):
        node_t = torch.tensor(node, dtype=torch.int32, device=cuda)
        before = hidden_store.write_node_hidden.launches
        got = hidden_store.write_node_hidden(store.clone(), node_t, leaf)
        want = hidden_store.write_node_hidden_plain(store.clone(), node_t, leaf)
        torch.cuda.synchronize()
        assert hidden_store.write_node_hidden.launches == before + 1
        assert torch.equal(got, want)
        others = torch.arange(N, device=cuda) != node
        assert torch.equal(got[others], store[others])
    with pytest.raises(ValueError, match="node"):
        hidden_store.write_node_hidden(store, 1, leaf)
    with pytest.raises(ValueError, match="leaf"):
        hidden_store.write_node_hidden(store, node_t, leaf[:, :1])


@pytest.mark.parametrize("N, B, rest, dtype", [
    (201, 256, (2688,), torch.float32),  # connect4's store: many blocks, several words a thread
    (9, 3, (5, 7, 9), torch.float32),  # 3,780 bytes a row: the 4-byte words
    (9, 3, (5, 7, 12), torch.float32),  # 5,040 bytes: 16-byte words, a part of one block's share
    (9, 1, (5,), torch.float32),  # 20 bytes: one 16-byte word and a 4-byte rest
    (9, 4, (6, 7), torch.bfloat16),  # a bf16 store given an f32 leaf
], ids=["connect4", "rest-5-7-9", "rest-5-7-12", "20-bytes", "bf16-store"])
def test_row_write_kernel_splits_rows_as_plain(cuda, N, B, rest, dtype):
    """The row write's grid and word split at the shapes they change with:
    the target row equals the leaf (cast to the store's dtype), every other
    row is unchanged; nodes N and -1 write nothing."""
    from muzero_general_tpu_torch.ops import hidden_store

    gen = torch.Generator(device=cuda).manual_seed(8)
    store = torch.randn((N, B) + rest, generator=gen, device=cuda).to(dtype)
    leaf = torch.randn((B,) + rest, generator=gen, device=cuda)
    for node in (0, N - 1, N, -1):
        node_t = torch.tensor(node, dtype=torch.int32, device=cuda)
        got = hidden_store.write_node_hidden(store.clone(), node_t, leaf)
        want = hidden_store.write_node_hidden_plain(store.clone(), node_t, leaf)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        others = torch.arange(N, device=cuda) != node
        assert torch.equal(got[others], store[others])
        if 0 <= node < N:
            assert torch.equal(got[node], leaf.to(dtype))
        del got, want


def test_connect4_multileaf_selfplay_runs_through_the_marking_kernels(cuda):
    cfg = connect4.MuZeroConfig()
    cfg.blocks, cfg.channels = 1, 16
    cfg.parallel_games, cfg.num_simulations, cfg.selfplay_chunk_moves = 16, 24, 2
    cfg.search_batch_leaves = 4
    driver = SelfPlayDriver(connect4.make_env(), MuZeroNetwork(cfg), cfg, seed=0)
    assert driver.spec.use_kernels and driver.spec.batch_leaves == 4
    d, b = mcts_kernels.descend_planar, mcts_kernels.backprop
    before = (d.marked_launches, b.pre_marked_launches, d.launches, b.launches)
    _, stats = driver.play(temperature=1.0)
    after = (d.marked_launches, b.pre_marked_launches, d.launches, b.launches)
    assert after == tuple(x + 48 for x in before)
    assert stats["env_steps"] == 32 and stats["max_tree_depth"] >= 2


def test_connect4_selfplay_runs_through_the_tree_kernels(cuda):
    cfg = connect4.MuZeroConfig()
    cfg.blocks, cfg.channels = 1, 16
    cfg.parallel_games, cfg.num_simulations, cfg.selfplay_chunk_moves = 16, 20, 3
    driver = SelfPlayDriver(connect4.make_env(), MuZeroNetwork(cfg), cfg, seed=0)
    assert driver.spec.use_kernels and not driver.use_fused
    before = (mcts_kernels.descend_planar.launches, mcts_kernels.backprop.launches)
    _, stats = driver.play(temperature=1.0)
    after = (mcts_kernels.descend_planar.launches, mcts_kernels.backprop.launches)
    assert after == (before[0] + 60, before[1] + 60)
    assert stats["env_steps"] == 48 and stats["max_tree_depth"] >= 2


# ---- the streaming search's kernels ----------------------------------------


def _slab(dev, num_players, B=64, sims=60, seed=0):
    """A real gomoku-shaped packed slab (1 x 16 ResNet, random init) after
    `sims` of 2 * sims simulations on the stream route, with its spec,
    int32 legal mask, min/max and depth bound."""
    cfg = gomoku.MuZeroConfig()
    cfg.blocks, cfg.channels = 1, 16
    cfg.num_simulations = 2 * sims
    cfg.players = list(range(num_players))
    net = fold_bn(MuZeroNetwork(cfg, device=dev, seed=seed))
    env = gomoku.make_env(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = env.reset(B, gen)
    for _ in range(6):
        state, _, _ = env.step(state, env.random_legal_action(state, gen), gen)
    spec = mcts_ops.SearchSpec.from_config(cfg, B, dev)._replace(use_kernels=False,
                                                                 use_stream=True)
    legal = env.legal_actions_mask(state)
    with torch.no_grad():
        out = mcts_ops.run_mcts(net.initial_inference, net.recurrent_inference,
                                env.observation(state), legal, env.to_play(state), gen,
                                spec, seed=seed, num_steps=sims)
    bound = (out.max_tree_depth.max() + 1).to(torch.int32)
    edges = mcts_stream.pack_tree(out.tree, legal.shape[1])
    return edges, out.tree, spec, legal.to(torch.int32), bound, sims


def _stream_args(edges, tree, spec, legal, bound, sim, seed, tie_jitter):
    args = (seed, sim, bound, edges, legal, tree.min_value, tree.max_value)
    kw = dict(num_players=spec.num_players, pb_c_base=spec.pb_c_base,
              pb_c_init=spec.pb_c_init, discount=spec.discount, A=legal.shape[1],
              max_depth=spec.max_depth, tie_jitter=tie_jitter)
    return args, kw


def _flat(out):
    return [*out[:5], *out[5]]


@pytest.mark.parametrize("num_players", [1, 2])
@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
def test_stream_descend_kernel_matches_plain(cuda, num_players, tie_jitter):
    edges, tree, spec, legal, bound, sim = _slab(cuda, num_players)
    args, kw = _stream_args(edges, tree, spec, legal, bound, sim, (1 << 33) + 9, tie_jitter)
    before = mcts_stream.descend_stream.launches
    got = mcts_stream.descend_stream(*args, **kw)
    want = mcts_stream.descend_stream_plain(*args, **kw)
    torch.cuda.synchronize()
    assert mcts_stream.descend_stream.launches == before + 1
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)
    assert int(got[2].min()) >= 1 and got[3].shape == (spec.max_depth + 1, 64)
    # A bound too small for the tree marks the cut lanes -1, as the plain one.
    args = args[:2] + (torch.tensor(1, dtype=torch.int32, device=cuda),) + args[3:]
    got = mcts_stream.descend_stream(*args, **kw)
    want = mcts_stream.descend_stream_plain(*args, **kw)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)
    assert bool((got[2] == -1).any())


@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
def test_stream_descend_kernel_breaks_exact_ties_as_plain(cuda, tie_jitter):
    """Fresh roots whose legal actions all score the same, A = 121 over the
    128 padded columns: without jitter the first legal index wins, with it
    the Philox stream decides; the kernel picks as the plain version."""
    B, N, A = 96, 9, 121
    edges = torch.zeros((B, N + 1, mcts_stream.S_PLANES, 128), device=cuda)
    edges[:, :N, mcts_stream.P_CHILD] = -1.0
    edges[:, :N, mcts_stream.P_PRIOR, :A] = 1.0 / A
    gen = torch.Generator(device=cuda).manual_seed(4)
    legal = (torch.rand((B, A), generator=gen, device=cuda) < 0.3).to(torch.int32)
    legal[:, A - 1] = 1
    inf = torch.full((B,), float("inf"), device=cuda)
    args = (7, 2, torch.tensor(3, dtype=torch.int32, device=cuda), edges, legal, inf, -inf)
    kw = dict(num_players=2, pb_c_base=19652.0, pb_c_init=1.25, discount=1.0, A=A,
              max_depth=N - 1, tie_jitter=tie_jitter)
    got = mcts_stream.descend_stream(*args, **kw)
    want = mcts_stream.descend_stream_plain(*args, **kw)
    for g, w in zip(_flat(got), _flat(want)):
        assert torch.equal(g, w)
    if tie_jitter == 0.0:
        assert torch.equal(got[1].long(), torch.argmax(legal, dim=1))


TABLE, TABLE_SUPPORT = 97, 5


def _table_slab(dev, A, num_players=2, B=64, sims=60, seed=0):
    """A packed slab of width A after `sims` of 2 * sims simulations on the
    stream route (its plain versions), from a table network: the policy,
    value and reward logits of a hidden id, the next id a function of the
    id and the action. Returns the slab, tree, spec, int32 legal mask and
    depth bound."""
    gen = torch.Generator().manual_seed(seed)
    full = 2 * TABLE_SUPPORT + 1
    tv, tr, tp = (torch.randn((TABLE, w), generator=gen).to(dev) for w in (full, full, A))

    def initial_fn(obs):
        ids = obs[:, 0].long()
        reward = torch.full_like(tr[ids], -1e9)
        reward[:, TABLE_SUPPORT] = 0.0
        return tv[ids], reward, tp[ids], obs

    def recurrent_fn(h, a):
        ids = (h[:, 0].long() * A + a.long() + 1) % TABLE
        return tv[ids], tr[ids], tp[ids], ids[:, None].to(torch.float32)

    obs = torch.randint(0, TABLE, (B, 1), generator=gen).to(torch.float32).to(dev)
    legal = torch.rand((B, A), generator=gen) < 0.75
    legal[torch.arange(B), torch.randint(0, A, (B,), generator=gen)] = True
    to_play = torch.randint(0, 2, (B,), generator=gen).to(torch.int32)
    spec = mcts_ops.SearchSpec(
        num_simulations=2 * sims, num_players=num_players, pb_c_base=19652.0, pb_c_init=1.25,
        discount=0.97 if num_players == 1 else 1.0, dirichlet_alpha=0.3,
        exploration_fraction=0.25, support_size=TABLE_SUPPORT, max_depth=2 * sims,
        use_stream=True)
    legal, to_play = legal.to(dev), to_play.to(dev)
    with torch.no_grad():
        out = mcts_ops.run_mcts(initial_fn, recurrent_fn, obs, legal, to_play,
                                torch.Generator(device=dev).manual_seed(seed), spec, seed=seed,
                                num_steps=sims, plain_kernels=True)
    bound = (out.max_tree_depth.max() + 1).to(torch.int32)
    edges = mcts_stream.pack_tree(out.tree, A)
    return edges, out.tree, spec, legal.to(torch.int32), bound


def _assert_descents_equal(args, kw):
    got = mcts_stream.descend_stream(*args, **kw)
    want = mcts_stream.descend_stream_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("parent", "action", "leaf_depth", "path_n", "path_a", "path_r",
                           "path_v", "path_s"), _flat(got), _flat(want)):
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
@pytest.mark.parametrize("A", [7, 121, 130, 361, 500, 600])
def test_stream_descend_kernel_matches_plain_at_row_widths(cuda, A, tie_jitter):
    """Real slabs one to five 128-column chunks wide (A_pad 128 to 640;
    above 512 columns the kernel reads a row in two passes): all eight
    outputs equal; then with the root edge of two lanes unexpanded (leaf
    depth 1) beside deep lanes; then with a bound of 2, which cuts lanes."""
    edges, tree, spec, legal, bound = _table_slab(cuda, A, num_players=1 + A % 2, seed=A)
    args, kw = _stream_args(edges, tree, spec, legal, bound, 60, (5 << 32) + A, tie_jitter)
    got = _assert_descents_equal(args, kw)
    assert int(got[2].min()) >= 1 and int(got[2].max()) >= 3
    shallow = edges.clone()
    shallow[[0, 5], 0, mcts_stream.P_CHILD] = -1.0
    got = _assert_descents_equal((*args[:3], shallow, *args[4:]), kw)
    assert got[2][[0, 5]].tolist() == [1, 1] and int(got[2].max()) >= 3
    cut = torch.tensor(2, dtype=torch.int32, device=cuda)
    got = _assert_descents_equal((*args[:2], cut, *args[3:]), kw)
    assert bool((got[2] == -1).any())


@pytest.mark.parametrize("A", [121, 130])
def test_stream_descend_kernel_matches_plain_on_extra_padding(cuda, A):
    """A slab padded 128 columns past pack_tree's width (A_pad not 128 x the
    chunks A needs, which the kernel reads with strides given at run time):
    all eight outputs equal, as on the packed slab."""
    edges, tree, spec, legal, bound = _table_slab(cuda, A, seed=A + 1)
    pad = torch.zeros(edges.shape[:3] + (128,), device=cuda)
    pad[:, :, mcts_stream.P_CHILD] = -1.0
    wide = torch.cat([edges, pad], dim=3).contiguous()
    for tie_jitter in (0.0, 1e-5):
        args, kw = _stream_args(wide, tree, spec, legal, bound, 60, 77, tie_jitter)
        got = _assert_descents_equal(args, kw)
        narrow = mcts_stream.descend_stream(*args[:3], edges, *args[4:], **kw)
        for g, w in zip(_flat(got), _flat(narrow)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("A", [121, 361])
@pytest.mark.parametrize("fractional", [False, True], ids=["whole-visits", "fractional-visits"])
def test_stream_descend_kernel_matches_plain_on_random_rows(cuda, A, fractional):
    """Random rows, not a search's: visit counts 0-7 (a row's sum stays
    below N, the plain version's numerator table), value sums from
    1e-38 to 1e30 in magnitude (below 2^-100 the kernel's quotients take
    the IEEE division), random priors, rewards and child links (cycles
    included; the bound cuts them); with fractional visits in a few rows
    the quotients take the IEEE division too. All eight outputs equal."""
    B, N = 64, 300
    gen = torch.Generator(device=cuda).manual_seed(A + fractional)
    A_pad = -(-A // 128) * 128
    edges = torch.zeros((B, N + 1, mcts_stream.S_PLANES, A_pad), device=cuda)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=cuda)

    visit = torch.where(rand(B, N, A) < 0.1, torch.floor(rand(B, N, A) * 8), 0.0)
    if fractional:
        visit[:, ::17] += 0.5 * (visit[:, ::17] > 0)
    scale = torch.pow(10.0, rand(B, N, A) * 68 - 38)
    edges[:, :N, mcts_stream.P_VISIT, :A] = visit
    edges[:, :N, mcts_stream.P_VSUM, :A] = (rand(B, N, A) * 2 - 1) * scale * (visit > 0)
    edges[:, :N, mcts_stream.P_REWARD, :A] = rand(B, N, A) * 2 - 1
    edges[:, :N, mcts_stream.P_PRIOR, :A] = rand(B, N, A) / A
    child = torch.floor(rand(B, N, A) * (N - 1)) + 1
    edges[:, :N, mcts_stream.P_CHILD] = -1.0
    edges[:, :N, mcts_stream.P_CHILD, :A] = torch.where(visit > 0, child, -1.0)
    legal = (rand(B, A) < 0.8).to(torch.int32)
    legal[:, 0] = 1
    lo = -rand(B)
    args = (3, 9, torch.tensor(40, dtype=torch.int32, device=cuda), edges, legal, lo, lo + 2)
    for num_players, jitter in ((1, 0.0), (2, 1e-5)):
        kw = dict(num_players=num_players, pb_c_base=19652.0, pb_c_init=1.25, discount=0.97,
                  A=A, max_depth=N - 1, tie_jitter=jitter)
        got = _assert_descents_equal(args, kw)
        assert bool((got[3][2] >= 0).any())  # some lane went two levels down


@pytest.mark.parametrize("A", [121, 130])
def test_stream_descend_kernel_truncates_the_visit_sum_once(cuda, A):
    """A root whose visits, 2.5 and 3.5, lie with different threads: the
    plain version truncates their float sum, 6, and so does the kernel;
    truncating each partial first would give 5. Column 8, unvisited, wins
    with the numerator of 6 and loses to column 0 (value 1.46) with that of
    5, so a wrong count changes the action."""
    B, N = 4, 9  # the plain version's numerator table holds counts 0 to N + 1
    edges = torch.zeros((B, N + 1, mcts_stream.S_PLANES, -(-A // 128) * 128), device=cuda)
    edges[:, :N, mcts_stream.P_CHILD] = -1.0
    edges[:, 0, mcts_stream.P_VISIT, 0] = 2.5
    edges[:, 0, mcts_stream.P_VISIT, 4] = 3.5
    edges[:, 0, mcts_stream.P_REWARD, 0] = 1.46
    edges[:, 0, mcts_stream.P_PRIOR, 8] = 0.5
    legal = torch.ones((B, A), dtype=torch.int32, device=cuda)
    lo = torch.zeros((B,), device=cuda)
    args = (1, 2, torch.tensor(3, dtype=torch.int32, device=cuda), edges, legal, lo, lo + 1)
    kw = dict(num_players=1, pb_c_base=19652.0, pb_c_init=1.25, discount=1.0, A=A,
              max_depth=N - 1, tie_jitter=0.0)
    got = _assert_descents_equal(args, kw)
    assert got[1].tolist() == [8] * B
    edges[:, 0, mcts_stream.P_VISIT, 4] = 2.5  # visits 5: column 0 wins
    got = _assert_descents_equal(args, kw)
    assert got[1].tolist() == [0] * B


def test_stream_descend_rejects_an_unaligned_slab(cuda):
    """The kernel reads rows in float4s: a slab view at an address not a
    multiple of 16 bytes is refused with a ValueError, not launched."""
    B, N1, A = 2, 3, 7
    base = torch.zeros(B * N1 * mcts_stream.S_PLANES * 128 + 1, device=cuda)
    edges = base[1:].view(B, N1, mcts_stream.S_PLANES, 128)
    legal = torch.ones((B, A), dtype=torch.int32, device=cuda)
    lo = torch.zeros((B,), device=cuda)
    kw = dict(num_players=1, pb_c_base=19652.0, pb_c_init=1.25, discount=1.0, A=A,
              max_depth=N1 - 2, tie_jitter=0.0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mcts_stream.descend_stream(1, 2, torch.tensor(1, dtype=torch.int32, device=cuda),
                                   edges, legal, lo, lo + 1, **kw)


@pytest.mark.parametrize("tie_jitter", [0.0, 1e-5])
def test_stream_descend_kernel_breaks_ties_on_a_two_chunk_row(cuda, tie_jitter):
    """All-tied fresh roots at A = 130 (A_pad 256): the tie spans both
    128-column chunks; without jitter the first legal index wins, with it
    the Philox stream decides, as in the plain version."""
    B, N, A = 64, 9, 130
    edges = torch.zeros((B, N + 1, mcts_stream.S_PLANES, 256), device=cuda)
    edges[:, :N, mcts_stream.P_CHILD] = -1.0
    edges[:, :N, mcts_stream.P_PRIOR, :A] = 1.0 / A
    gen = torch.Generator(device=cuda).manual_seed(5)
    legal = (torch.rand((B, A), generator=gen, device=cuda) < 0.3).to(torch.int32)
    legal[:, 129] = 1
    legal[:3] = 0
    legal[:3, 128:] = 1  # lanes whose legal actions all lie in the second chunk
    inf = torch.full((B,), float("inf"), device=cuda)
    args = (11, 4, torch.tensor(3, dtype=torch.int32, device=cuda), edges, legal, inf, -inf)
    kw = dict(num_players=2, pb_c_base=19652.0, pb_c_init=1.25, discount=1.0, A=A,
              max_depth=N - 1, tie_jitter=tie_jitter)
    got = _assert_descents_equal(args, kw)
    if tie_jitter == 0.0:
        assert torch.equal(got[1].long(), torch.argmax(legal, dim=1))
        assert got[1][:3].tolist() == [128, 128, 128]


@pytest.mark.parametrize("num_players", [1, 2])
def test_update_edges_kernel_matches_plain(cuda, num_players):
    """Real paths with some lanes cut to depth 1 while the bound stays the
    deepest lane's: masked levels aim at the dummy row, as backprop_stream
    aims them. Every live row equal; each live level adds one visit."""
    edges, tree, spec, legal, bound, sim = _slab(cuda, num_players, seed=1)
    args, kw = _stream_args(edges, tree, spec, legal, bound, sim, 5, 1e-5)
    _, _, leaf_depth, path_n, path_a, _ = mcts_stream.descend_stream(*args, **kw)
    leaf_depth[::5] = 1
    D, B = path_n.shape
    mask = torch.arange(D, device=cuda)[:, None] < leaf_depth[None, :].long()
    gen = torch.Generator(device=cuda).manual_seed(2)
    delta = torch.randn((D, B), generator=gen, device=cuda) * mask
    pn = torch.where(mask, path_n, edges.shape[1] - 1)
    pa = torch.where(mask, path_a, 0)
    top = torch.amax(leaf_depth)
    assert int(top) > 1
    outs = []
    for fn in (mcts_stream.update_edges, mcts_stream.update_edges_plain):
        outs.append(fn(edges.clone(), pn, pa, delta, mask.to(torch.float32), top))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][:, :-1], outs[1][:, :-1])
    visits = outs[0][:, :-1, mcts_stream.P_VISIT] - edges[:, :-1, mcts_stream.P_VISIT]
    assert int(visits.sum()) == int(leaf_depth.sum())


def _update_case(dev, D, B, bound, seed, holes=False):
    """A random packed slab [B, N + 1, 8, 128] (A = 121) and [D, B] paths
    made with numpy from `seed`: lane b is live to a random depth below D,
    on distinct edges (its nodes in increasing order); `holes` masks every
    lane at some levels above its leaf too. Masked levels aim at the dummy
    row N with delta 0, as backprop_stream hands them over."""
    rng = np.random.default_rng(seed)
    N, A = D + 8, 121
    edges = rng.normal(size=(B, N + 1, mcts_stream.S_PLANES, 128)).astype(np.float32)
    edges[:, :, mcts_stream.P_VISIT] = rng.integers(0, 9, (B, N + 1, 128))
    depth = rng.integers(0, D + 1, B)
    mask = np.arange(D)[:, None] < depth[None, :]
    if holes:
        for b in range(B):
            mask[rng.integers(0, max(depth[b], 1), 1 + D // 8), b] = False
    nodes = np.stack([np.sort(rng.choice(N, D, replace=False)) for _ in range(B)], 1)
    pn = np.where(mask, nodes, N).astype(np.int32)
    pa = np.where(mask, rng.integers(0, A, (D, B)), 0).astype(np.int32)
    delta = (rng.normal(size=(D, B)) * mask).astype(np.float32)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (to(edges), to(pn), to(pa), to(delta), to(mask.astype(np.float32)),
            torch.tensor(bound, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("D, B, bound, holes", [
    (401, 64, 0, False),  # bound 0: nothing to update
    (401, 64, 401, False),  # bound = D: every level below it
    (37, 7, 20, False),  # D x B = 259: not a multiple of the block
    (401, 64, 300, True),  # every lane masked at some levels above its leaf
], ids=["bound-0", "bound-D", "ragged", "holes"])
def test_update_edges_kernel_matches_plain_on_random_paths(cuda, D, B, bound, holes):
    """The whole slab, dummy row included, bit for bit after one update
    (floats compared as int32); each live level adds one visit."""
    edges, pn, pa, delta, mask, top = _update_case(cuda, D, B, bound, D + B, holes)
    before = mcts_stream.update_edges.launches
    got = mcts_stream.update_edges(edges.clone(), pn, pa, delta, mask, top)
    want = mcts_stream.update_edges_plain(edges.clone(), pn, pa, delta, mask, top)
    torch.cuda.synchronize()
    assert mcts_stream.update_edges.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    live = int((mask[:bound] != 0).sum())
    added = got[:, :, mcts_stream.P_VISIT] - edges[:, :, mcts_stream.P_VISIT]
    assert int(added.sum()) == live and (live > 0) == (bound > 0)
    if holes:
        assert bool((mask[:bound] == 0).any(0).all())


def test_stream_kernels_reject_bad_inputs(cuda):
    edges, tree, spec, legal, bound, sim = _slab(cuda, 2, B=8, sims=6)
    args, kw = _stream_args(edges, tree, spec, legal, bound, sim, 0, 0.0)
    with pytest.raises(ValueError, match="dtype"):
        mcts_stream.descend_stream(*args[:4], legal.bool(), *args[5:], **kw)
    with pytest.raises(ValueError, match="depth_bound"):
        mcts_stream.descend_stream(*args[:2], int(bound), *args[3:], **kw)
    with pytest.raises(ValueError, match="edges"):
        mcts_stream.descend_stream(*args[:3], edges[:, :, :5], *args[4:], **kw)
    _, _, depth, path_n, path_a, _ = mcts_stream.descend_stream(*args, **kw)
    zeros = torch.zeros(path_n.shape, device=cuda)
    with pytest.raises(ValueError, match="on cpu"):
        mcts_stream.update_edges(edges, path_n.cpu(), path_a, zeros, zeros, bound)
    with pytest.raises(ValueError, match="bound"):
        mcts_stream.update_edges(edges, path_n, path_a, zeros, zeros, 3)


def test_gomoku_selfplay_runs_through_the_stream_kernels(cuda):
    cfg = gomoku.MuZeroConfig()
    cfg.blocks, cfg.channels = 1, 16
    cfg.parallel_games, cfg.num_simulations, cfg.selfplay_chunk_moves = 16, 400, 2
    driver = SelfPlayDriver(gomoku.make_env(), MuZeroNetwork(cfg), cfg, seed=0)
    assert driver.spec.use_stream and not driver.spec.use_kernels and driver.fold_bn
    before = (mcts_stream.descend_stream.launches, mcts_stream.update_edges.launches)
    _, stats = driver.play(temperature=1.0)
    after = (mcts_stream.descend_stream.launches, mcts_stream.update_edges.launches)
    assert after == (before[0] + 800, before[1] + 800)
    assert stats["env_steps"] == 32 and stats["max_tree_depth"] >= 2


# ---- the probes' kernels and the bf16 networks --------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(4, 5, 5, 16), (2, 6, 7, 32), (3, 3, 5, 48),
                                   (64, 11, 11, 128), (16, 6, 7, 64), (2048, 6, 7, 64),
                                   (1, 1, 1, 16), (5, 7, 9, 80), (2, 5, 5, 192), (1, 3, 130, 16)])
def test_conv_probe_kernels_match_plain(cuda, shape, dtype):
    """Both conv kernels against their plain versions, into a fresh output
    and into a padded one (interior only): bf16 within 8e-3 of max |plain|
    (one bf16 ulp: the tensor cores sum in another order), f32 1e-5.
    (2048, 6, 7, 64) gives the persistent grid more tiles than SMs; (1, 1,
    1, 16) a single-pixel tile; (5, 7, 9, 80) a last tile that no tile
    height divides and a channel chunk zero-filled past C; (2, 5, 5, 192)
    two column tiles and an im2col patch tile too large to keep whole;
    (1, 3, 130, 16) a row wider than a tile."""
    import torch.nn.functional as F

    from muzero_general_tpu_torch.tools import conv_probe

    B, H, W, C = shape
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    x, w, b = conv_probe.probe_inputs(B, H, W, C, dtype, cuda, seed=C)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    for kernel, plain, wk in ((conv_probe.conv_9dot, conv_probe.conv_9dot_plain,
                               w.reshape(9, C, C)),
                              (conv_probe.conv_im2col, conv_probe.conv_im2col_plain,
                               w.reshape(9 * C, C))):
        before = kernel.launches
        got = kernel(xp, wk, b)
        padded = kernel(xp, wk, b, torch.full_like(xp, 5.0))
        want = plain(xp, wk, b)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        assert got.dtype == dtype and got.shape == (B, H, W, C)
        assert conv_probe.relative_error(got, want) <= tol
        assert torch.equal(padded[:, 1:-1, 1:-1], got)
        border = torch.ones(padded.shape[:3], dtype=torch.bool, device=cuda)
        border[:, 1:-1, 1:-1] = False
        assert bool((padded[border] == 5.0).all())
        lib = conv_probe.library_conv(x, conv_probe.library_weight(w), b[0])
        assert conv_probe.relative_error(got, lib) < conv_probe.LIBRARY_TOL


def test_conv_probe_kernels_reject_what_they_cannot_run(cuda):
    import torch.nn.functional as F

    from muzero_general_tpu_torch.tools import conv_probe

    x, w, b = conv_probe.probe_inputs(2, 4, 4, 16, torch.bfloat16, cuda)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    with pytest.raises(ValueError, match="dtype"):
        conv_probe.conv_9dot(xp, w.reshape(9, 16, 16).float(), b)
    with pytest.raises(ValueError, match="is on"):
        conv_probe.conv_im2col(xp, w.reshape(144, 16).cpu(), b)
    # A contiguous xp that starts 16 bytes past an aligned address.
    shifted = torch.empty(xp.numel() + 8, dtype=xp.dtype, device=cuda)[8:].view(xp.shape)
    shifted.copy_(xp)
    with pytest.raises(ValueError, match="aligned"):
        conv_probe.conv_9dot(shifted, w.reshape(9, 16, 16), b)


@pytest.mark.parametrize("levels", [1, 7, 64])
def test_pointer_chase_kernel_matches_plain(cuda, levels):
    """The stream probe's chase at gomoku's slab shape: the same rows, float32
    sums in another order (1e-5 relative)."""
    from muzero_general_tpu_torch.tools import stream_probe

    slab = torch.from_numpy(stream_probe.probe_slab(64, 402, 8, 128)).to(cuda)
    lv = torch.tensor([levels], dtype=torch.int32, device=cuda)
    before = stream_probe.pointer_chase.launches
    got = stream_probe.pointer_chase(lv, slab)
    want = stream_probe.pointer_chase_plain(lv, slab)
    torch.cuda.synchronize()
    assert stream_probe.pointer_chase.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


# Rows of 4 floats, of 1,024 and of 5,120 (20 KB: wider than a 16 KB ring
# stage, so each row goes as two bulk copies).
@pytest.mark.parametrize("row", [(1, 4), (8, 128), (4, 1280)], ids=["4", "1024", "5120"])
@pytest.mark.parametrize("levels", [0, 1, 64])
@pytest.mark.parametrize("B", [1, 7, 64, 200])  # 200 lanes: more than the card's SMs
def test_pointer_chase_kernel_matches_plain_at_shapes(cuda, B, levels, row):
    from muzero_general_tpu_torch.tools import stream_probe

    S, A = row
    slab = torch.from_numpy(stream_probe.probe_slab(B, 48, S, A, seed=B)).to(cuda)
    lv = torch.tensor([levels], dtype=torch.int32, device=cuda)
    got = stream_probe.pointer_chase(lv, slab)
    want = stream_probe.pointer_chase_plain(lv, slab)
    torch.cuda.synchronize()
    assert got.shape == (B, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("B", [7, 200])
def test_pointer_chase_kernel_clamps_pointers_as_plain(cuda, B):
    """Pointers below 0 and at or past N (up to 1e6) clamp to the end rows."""
    from muzero_general_tpu_torch.tools import stream_probe

    N = 32
    slab_np = stream_probe.probe_slab(B, N, 8, 128, seed=1)
    rng = np.random.default_rng(2)
    slab_np[:, :, 0, 0] = rng.integers(-3 * N, 3 * N, (B, N))
    slab_np[:, ::5, 0, 0] = 1e6
    slab = torch.from_numpy(slab_np).to(cuda)
    lv = torch.tensor([64], dtype=torch.int32, device=cuda)
    got = stream_probe.pointer_chase(lv, slab)
    want = stream_probe.pointer_chase_plain(lv, slab)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_pointer_chase_counts_the_launches_its_timing_runs(cuda):
    """chase_times and one_call_ms count the kernels each CUDA-graph replay
    runs, not the launches its capture records."""
    from muzero_general_tpu_torch.tools import stream_probe

    slab = torch.from_numpy(stream_probe.probe_slab(8, 16, 8, 128)).to(cuda)
    lv = torch.tensor([4], dtype=torch.int32, device=cuda)
    before = stream_probe.pointer_chase.launches
    stream_probe.chase_times(lv, slab, reps=3, graphs=5)
    # 3 calls from Python, then 1 + 5 replays of a graph of 3 calls
    assert stream_probe.pointer_chase.launches - before == 3 + 6 * 3
    before = stream_probe.pointer_chase.launches
    stream_probe.one_call_ms(lv, slab, cold=False, reps=3)  # a warm-up and a timed replay each
    assert stream_probe.pointer_chase.launches - before == 6
    before = stream_probe.pointer_chase.launches
    stream_probe.one_call_ms(lv, slab, cold=True, reps=3)
    assert stream_probe.pointer_chase.launches - before == 3


def test_stream_probe_library_declares_the_c_interface_of_its_source(cuda):
    """The built library's ctypes declarations against the `extern "C"`
    signatures of csrc/stream_probe.cu, and a refused launch reported."""
    import ctypes
    import re

    from muzero_general_tpu_torch.native import build

    source = (build.CSRC_DIR / "stream_probe.cu").read_text()
    defined = {fn: len(params.split(",")) for fn, params in
               re.findall(r'extern "C" [\w ]+\*? (\w+)\(([^)]*)\)', source)}
    lib = build.load_library("stream_probe")
    declared = {fn: len(getattr(lib, fn).argtypes) for fn in build._KERNELS["stream_probe"]["api"]}
    assert defined == declared
    assert lib.stream_probe_chase.restype is ctypes.c_int
    assert lib.stream_probe_chase.argtypes[:3] == [ctypes.c_void_p] * 3
    assert lib.stream_probe_chase.argtypes[-1] is ctypes.c_void_p  # the stream
    # row_floats not a multiple of 4: cudaErrorInvalidValue, no launch.
    rc = lib.stream_probe_chase(0, 0, 0, 1, 1, 6, 0)
    assert rc == 1 and b"invalid" in lib.stream_probe_error_string(rc)


@pytest.mark.parametrize("variant", ["unfolded", "folded", "folded_bf16_acts"])
def test_bf16_resnet_on_the_card_matches_the_cpu(cuda, variant):
    """The pretrained connect4 ResNet at bf16 on the card against the same
    net on the CPU. Each conv's bf16 output may round the other way where
    cuDNN's float32 sum order differs from the CPU's, and the flip travels
    through up to 13 convs: logits within 3e-2 of the batch's largest, hidden
    states (normalized to [0, 1]) within 3e-2, a few bf16 ulps."""
    import pathlib

    from muzero_general_tpu_torch.checkpoint import load_checkpoint
    from muzero_general_tpu_torch.models import activation_dtype, params_from_jax

    cfg = connect4.MuZeroConfig()
    cfg.compute_dtype = "bfloat16"
    cfg.search_bf16_activations = variant == "folded_bf16_acts"
    path = pathlib.Path(__file__).resolve().parents[1] / "pretrained/connect4/model.checkpoint"
    state = params_from_jax(load_checkpoint(path)["weights"])
    nets = []
    for dev in ("cpu", cuda):
        net = MuZeroNetwork(cfg, device=dev)
        net.load_state_dict(state)
        nets.append(net if variant == "unfolded" else fold_bn(net, activation_dtype(cfg)))
    env = connect4.make_env(device="cpu")
    gen = torch.Generator().manual_seed(3)
    state0 = env.reset(32, gen)
    for _ in range(5):
        state0, _, _ = env.step(state0, env.random_legal_action(state0, gen), gen)
    obs = env.observation(state0)
    action = torch.arange(32) % 7
    outs = []
    with torch.no_grad():
        for net, dev in zip(nets, ("cpu", cuda)):
            init = net.initial_inference(obs.to(dev))
            rec = net.recurrent_inference(init[3], action.to(dev))
            outs.append([t.cpu() for t in (*init, *rec)])
    for i, (got, want) in enumerate(zip(outs[1], outs[0])):
        assert got.dtype == want.dtype
        if i % 4 == 3:  # hidden states
            assert got.dtype == (torch.bfloat16 if variant == "folded_bf16_acts"
                                 else torch.float32)
            torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=3e-2)
        elif i != 1:  # logits (the initial reward is the fixed log one-hot)
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=3e-2 * scale)


def test_cartpole_search_too_big_for_the_fused_kernel_plays_on_the_staged_route(cuda):
    """1,000 simulations overflow the fused kernel's shared memory: the
    kernel still refuses them (-2), and the driver routes to the staged
    search, as the JAX driver does."""
    cfg = MuZeroConfig()
    cfg.num_simulations, cfg.selfplay_chunk_moves = 1000, 1
    G = cfg.parallel_games  # 16: a 1,001-node tree fits the planar kernels
    assert not mcts_fused.fits_kernel(cfg)
    args, kw, _ = _inputs(cfg, G, 1, False, 0, cuda)
    with pytest.raises(RuntimeError, match="shared memory"):
        mcts_fused.search(*args, **kw)
    driver = SelfPlayDriver(make_env(), MuZeroNetwork(cfg), cfg, seed=0)
    assert (driver.search_route, driver.use_fused) == ("staged", False)
    assert driver.spec.use_kernels
    fused_before = mcts_fused.search.launches
    descents_before = mcts_kernels.descend_planar.launches
    record = driver.play_chunk(torch.ones((G,)), 1)
    torch.cuda.synchronize()
    assert mcts_fused.search.launches == fused_before
    assert mcts_kernels.descend_planar.launches == descents_before + 1000
    torch.testing.assert_close(record.child_visits.sum(-1), torch.ones((1, G), device=cuda))


def _learner_config(network, optimizer):
    cfg = BaseConfig()
    cfg.observation_shape, cfg.action_space = (1, 1, 4), list(range(2))
    cfg.encoding_size, cfg.support_size = 4, 5
    cfg.fc_dynamics_layers = cfg.fc_reward_layers = [8]
    cfg.fc_value_layers = cfg.fc_policy_layers = [8]
    cfg.num_unroll_steps, cfg.batch_size, cfg.optimizer = 3, 4, optimizer
    if network == "resnet":
        cfg.network, cfg.observation_shape, cfg.action_space = "resnet", (3, 3, 3), list(range(9))
        cfg.blocks, cfg.channels = 1, 8
        cfg.reduced_channels_reward = cfg.reduced_channels_value = 2
        cfg.reduced_channels_policy = 2
        cfg.resnet_fc_reward_layers = cfg.resnet_fc_value_layers = [8]
        cfg.resnet_fc_policy_layers = [8]
    return cfg


def _learner_batches(cfg, M, seed=0):
    rng = np.random.default_rng(seed)
    B, U, A = cfg.batch_size, cfg.num_unroll_steps, len(cfg.action_space)
    c, h, w = cfg.observation_shape
    return {
        "observation": rng.normal(size=(M, B, c, h, w)).astype(np.float32),
        "action": rng.integers(0, A, (M, B, U + 1)).astype(np.int32),
        "target_value": (5 * rng.normal(size=(M, B, U + 1))).astype(np.float32),
        "target_reward": rng.normal(size=(M, B, U + 1)).astype(np.float32),
        "target_policy": rng.dirichlet(np.ones(A), (M, B, U + 1)).astype(np.float32),
        "weight": rng.uniform(0.2, 1.0, (M, B)).astype(np.float32),
        "gradient_scale": rng.integers(1, U + 1, (M, B, U + 1)).astype(np.float32),
    }


@pytest.mark.parametrize("network", ["fullyconnected", "resnet"])
@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
def test_learner_on_the_card_matches_the_cpu(cuda, network, optimizer):
    """A fused 8-step call on the card against the same call on the CPU, f32,
    from the same weights and batches. Tolerances as tests/test_torch_trainer.py
    holds the port against JAX: losses rtol 2e-5, priorities rtol 1e-4,
    params 1e-5 (Adam: 1% of lr * steps), running statistics rtol 1e-4."""
    from muzero_general_tpu_torch.trainer import Learner

    cfg = _learner_config(network, optimizer)
    learners = [Learner(cfg, device=dev, seed=0) for dev in ("cpu", cuda)]
    batches = _learner_batches(cfg, 8)
    (m_cpu, p_cpu), (m_gpu, p_gpu) = (learner.train_steps(batches) for learner in learners)
    for key in ("total_loss", "value_loss", "reward_loss", "policy_loss"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], rtol=2e-5, atol=1e-5)
    assert m_gpu["lr"] == m_cpu["lr"]
    torch.testing.assert_close(p_gpu.cpu(), p_cpu, rtol=1e-4, atol=1e-5)
    atol = 1e-2 * cfg.lr_init * 8 if optimizer == "Adam" else 1e-5
    s_cpu, s_gpu = (learner.network.state_dict() for learner in learners)
    for key, want in s_cpu.items():
        got = s_gpu[key].cpu()
        if key.endswith("running_mean") or key.endswith("running_var"):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5, msg=key)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=key)


@pytest.mark.parametrize("game", ["tictactoe", "cartpole"])
def test_eval_game_on_the_card_matches_the_cpu(cuda, game):
    """evaluate.play_against_opponent, the B = 1 search (the plain-op route
    on any device: no lane block of the kernels fits one lane), on the card
    against the CPU from the same weights, with first-index ties and no root
    noise: tictactoe against the random opponent (numpy draws on both),
    cartpole against itself from one start state. Actions, rewards and
    visits exact; root values within 5e-5."""
    from muzero_general_tpu_torch import evaluate
    from muzero_general_tpu_torch.config import load_game_module

    module = load_game_module(game)
    cfg = module.MuZeroConfig()
    cfg.num_simulations, cfg.root_exploration_fraction, cfg.max_moves = 16, 0.0, 40
    if game == "tictactoe":
        cfg.channels, cfg.reduced_channels_reward = 8, 2
        cfg.reduced_channels_value = cfg.reduced_channels_policy = 2
    from_config = mcts_ops.SearchSpec.from_config.__func__

    def deterministic(cls, *args, **kwargs):
        spec = from_config(cls, *args, **kwargs)
        assert not spec.use_kernels and not spec.use_stream
        return spec._replace(deterministic_tie_break=True)

    games = []
    original = mcts_ops.SearchSpec.from_config
    mcts_ops.SearchSpec.from_config = classmethod(deterministic)
    try:
        cpu_net = MuZeroNetwork(cfg, device="cpu", seed=4)
        for dev in ("cpu", cuda):
            net = MuZeroNetwork(cfg, device=dev, seed=4)
            net.load_state_dict(cpu_net.state_dict())
            env = module.make_env(device=dev)
            opponent = "random" if game == "tictactoe" else "self"
            games.append(evaluate.play_against_opponent(
                env, net, cfg, opponent, 1, seed=3, start=[0.01, -0.02, 0.03, 0.0]
                if game == "cartpole" else None))
    finally:
        mcts_ops.SearchSpec.from_config = original
    cpu, gpu = games
    assert len(gpu) == len(cpu) >= 5
    for field in ("actions", "rewards", "to_play", "child_visits"):
        np.testing.assert_array_equal(getattr(gpu, field), getattr(cpu, field), err_msg=field)
    np.testing.assert_allclose(gpu.root_values, cpu.root_values, rtol=0, atol=5e-5)
