"""Batched, array-based MCTS: the staged search (port of ops/mcts.py).

B independent game trees advance in lockstep, one batched network call per
simulation, with the reference search's semantics (self_play.py:249-476):
pUCT with min-max normalized values (negated for two players), a uniform
random choice among tied scores (or the first index with
deterministic_tie_break), the root expanded over legal actions with optional
Dirichlet noise, interior nodes over the full action space, and a backprop
with player signs, discount and MinMaxStats.

Storage is the JAX package's: statistics live on EDGES ([B, N, A], node-major;
[B, A, N] "planar" on the kernel route), the root keeps [B] scalars, and the
player at depth t is (root player + t) % players, so backprop signs are depth
parity. Each simulation expands one node, so S simulations need N = S + 1
slots; the root is node 0.

Three routes per simulation, chosen by SearchSpec.use_kernels and
use_stream (config `use_pallas_mcts`, `use_stream_mcts`), as the JAX package
chooses between XLA, its planar Pallas kernels and its streaming ones:
- the kernel route: the planar descent and the leaf-to-root backprop are one
  CUDA kernel launch each (ops/mcts_kernels.py, csrc/mcts_kernels.cu), with
  the depth bound passed as a device scalar so the simulation loop never
  waits on the host;
- the stream route, for trees too big for the planar kernels (gomoku): the
  tree is one packed slab per move, the descent and the backprop's edge
  updates are one CUDA kernel launch each (ops/mcts_stream.py,
  csrc/mcts_stream.cu), and the backprop's fold runs as PyTorch ops over the
  depth-major path, with the bounds again device scalars;
- the plain-op route: the descent in PyTorch ops level by level, and the
  backprop as one reverse associative scan over the path
  (_backprop_vectorized), as the JAX package's XLA path.

Multi-leaf rounds (SearchSpec.batch_leaves = K > 1, config
`search_batch_leaves`; JAX ops/mcts.py _run_rounds_multileaf): each round
makes K selections with virtual visits marked between them (in the descend
kernel on the kernel route, by `_apply_virtual_marks` on the plain-op route),
then one recurrent inference over the K * B leaves, one batched expansion
(a selection that repeats an earlier one of its round writes onto its own
orphan node row instead) and the backprop of the K paths with the visits
pre-marked: K backprop launches on the kernel route, one multi-path
`_backprop_vectorized` on the plain-op route. The stream route is K = 1
only, as in the JAX package.

The hidden store is node-major [N, B, ...]. The JAX package defers each
leaf's store write to the next simulation (`_flush_pending`), and at K > 1
the K rows of a round to the next round's start as one block, only to keep
XLA from copying the store; here each leaf's row (each round's K rows) is
written in place at once. The results are the same: the nodes a simulation
(a round) expands are reachable only from the next one on.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.ops import mcts_kernels
from muzero_general_tpu_torch.ops.philox import TIE_JITTER
from muzero_general_tpu_torch.ops.support import support_to_scalar


def resolve_fast_path_flag(flag, device) -> bool:
    """A knob that may be True/False/"auto": "auto" engages the kernels on
    a CUDA device (JAX: on an accelerator backend) and not on the CPU."""
    if flag == "auto":
        return torch.device(device).type == "cuda"
    return bool(flag)


class SearchSpec(NamedTuple):
    """Static search hyperparameters (config group 'Self-Play')."""

    num_simulations: int
    num_players: int
    pb_c_base: float
    pb_c_init: float
    discount: float
    dirichlet_alpha: float
    exploration_fraction: float
    support_size: int
    max_depth: int  # static bound on tree depth (= num_simulations)
    # Testing hook: the first max-score action instead of a uniform choice
    # among ties, and no tie jitter on the kernel route.
    deterministic_tie_break: bool = False
    # The descend/backprop kernels on planar slabs (config use_pallas_mcts),
    # for the tree sizes where the JAX package engages its Pallas kernels.
    use_kernels: bool = False
    # Plain-op route: the descent captures each selected edge's (reward,
    # visit, vsum) so the backprop needs no slab gathers; off above 256
    # simulations, as in the JAX package.
    capture_path_stats: bool = True
    # The stream kernels on the packed slab (config use_stream_mcts), for
    # trees the planar kernels refuse, where the JAX package streams them.
    use_stream: bool = False
    # Multi-leaf rounds: K selections with virtual-visit marks between them,
    # one network call over the K leaves (config search_batch_leaves). K = 1
    # is the reference search; K > 1 approximates it (in-flight marks steer
    # a round's later selections before the values land).
    batch_leaves: int = 1

    @property
    def tie_jitter(self) -> float:
        """The kernel route's score jitter (0 with deterministic ties)."""
        return 0.0 if self.deterministic_tie_break else TIE_JITTER

    @classmethod
    def from_config(cls, config, batch_size=None, device=None):
        """The JAX package's SearchSpec.from_config: the kernel route where
        `use_pallas_mcts` resolves on `device` and the tree fits the JAX
        package's planar and backprop kernels at `batch_size` lanes; else,
        for one leaf per simulation, batch_size >= 8 and `use_stream_mcts`
        resolving too, the stream route. device=None means the card
        (device.resolve_device), as at every entry point of the port."""
        if len(config.players) > 2:
            raise NotImplementedError("More than two player mode not implemented.")
        batch_leaves = int(getattr(config, "search_batch_leaves", 1))
        if batch_leaves < 1 or config.num_simulations % batch_leaves:
            raise ValueError(
                "search_batch_leaves must be >= 1 and divide num_simulations "
                f"(got {batch_leaves} for {config.num_simulations} simulations)"
            )
        if device is None:
            device = resolve_device()
        use_kernels = resolve_fast_path_flag(
            getattr(config, "use_pallas_mcts", False), device
        )
        use_stream = False
        if use_kernels and batch_size is not None:
            N = config.num_simulations + 1
            A = len(config.action_space)
            use_kernels = (
                mcts_kernels.choose_block_planar(batch_size, N, A) is not None
                and mcts_kernels.choose_block_backprop(batch_size, N, A) is not None
            )
            # Trees too big for the planar kernels stream instead (K = 1
            # only: multi-leaf rounds keep the plain-op route; batch-1 eval
            # lanes too, as in JAX).
            use_stream = (
                not use_kernels and batch_leaves == 1 and batch_size >= 8
                and resolve_fast_path_flag(getattr(config, "use_stream_mcts", "auto"), device)
            )
        return cls(
            num_simulations=config.num_simulations,
            num_players=len(config.players),
            pb_c_base=float(config.pb_c_base),
            pb_c_init=float(config.pb_c_init),
            discount=float(config.discount),
            dirichlet_alpha=float(config.root_dirichlet_alpha),
            exploration_fraction=float(config.root_exploration_fraction),
            support_size=config.support_size,
            max_depth=config.num_simulations,
            use_kernels=use_kernels,
            capture_path_stats=config.num_simulations <= 256,
            use_stream=use_stream,
            batch_leaves=batch_leaves,
        )


class Tree(NamedTuple):
    """SoA tree storage, N = num_simulations + 1 node slots, root = node 0.

    Statistics are per EDGE: [B, N, A] node-major, or [B, A, N] planar on
    the kernel route (_to_planar). The search updates the tensors in place.
    """

    children_index: torch.Tensor  # int32, -1 = unexpanded edge
    children_prior: torch.Tensor  # float32
    children_visit: torch.Tensor  # int32 edge visit counts
    children_vsum: torch.Tensor  # float32 edge value sums
    children_reward: torch.Tensor  # float32 child node rewards
    root_legal: torch.Tensor  # [B, A] bool
    root_visit: torch.Tensor  # [B] int32: the root has no incoming edge
    root_vsum: torch.Tensor  # [B] float32
    root_reward: torch.Tensor  # [B] float32
    root_to_play: torch.Tensor  # [B] int32
    min_value: torch.Tensor  # [B] MinMaxStats minimum
    max_value: torch.Tensor  # [B] MinMaxStats maximum

    def root_value(self):
        """Root Node.value(): value_sum / visit_count, 0 if unvisited
        (reference self_play.py:446-449)."""
        v = self.root_visit
        return torch.where(v > 0, self.root_vsum / torch.clamp(v, min=1), 0.0)


class MCTSOutput(NamedTuple):
    root_visit_counts: torch.Tensor  # [B, A] int32
    root_value: torch.Tensor  # [B]
    root_predicted_value: torch.Tensor  # [B] network value at the root
    max_tree_depth: torch.Tensor  # [B] int32
    tree: Tree  # node-major
    root_hidden: torch.Tensor = None  # [B, ...] the root's hidden state


def masked_softmax(logits, mask):
    """Softmax over masked entries; masked-out entries get exactly 0."""
    neg = torch.finfo(logits.dtype).min
    z = torch.where(mask, logits, neg)
    z = z - torch.amax(z, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(z), 0.0)
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)


def sample_gamma(alpha: float, shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Gamma(alpha, 1) draws from an explicit generator.

    torch's own gamma sampler takes no generator, so this is Marsaglia and
    Tsang's method (ACM TOMS 26(3), 2000) on torch.randn/torch.rand: rejection
    rounds until every entry is accepted, and for alpha < 1 a Gamma(alpha+1)
    draw times U^(1/alpha).
    """
    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, device=device)
    pending = torch.ones(shape, dtype=torch.bool, device=device)
    while True:
        x = torch.randn(shape, generator=generator, device=device)
        u = torch.rand(shape, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        log_v = torch.log(torch.clamp(v, min=1e-30))
        accept = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        take = pending & accept
        out = torch.where(take, d * v, out)
        pending = pending & ~accept
        if not bool(pending.any()):
            break
    if boost:
        u = torch.rand(shape, generator=generator, device=device)
        out = out * torch.exp(torch.log(u) / alpha)
    return out


def add_root_noise(prior, legal_mask, dirichlet_alpha: float,
                   exploration_fraction: float,
                   generator: Optional[torch.Generator] = None,
                   root_noise: Optional[torch.Tensor] = None):
    """Mix Dirichlet noise into the legal root prior (reference
    self_play.py:467-476; JAX ops/mcts.py:1040-1049).

    Dirichlet over the legal subset == normalized masked Gamma draws. The
    Gammas [B, A] are drawn from `generator`, or taken from `root_noise`
    (tests inject the JAX side's own draw).
    """
    if root_noise is None:
        root_noise = sample_gamma(dirichlet_alpha, tuple(prior.shape), generator,
                                  prior.device)
    g = torch.where(legal_mask, root_noise.to(prior.dtype), 0.0)
    noise = g / torch.clamp(torch.sum(g, dim=-1, keepdim=True), min=1e-30)
    frac = exploration_fraction
    return torch.where(legal_mask, prior * (1 - frac) + noise * frac, 0.0)


def select_action(generator, visit_counts, legal_mask, temperature):
    """Sample an action from root visit counts with temperature.

    Parity: reference self_play.py:222-245 (JAX ops/mcts.py:1207-1236):
    T=0 -> argmax, T=inf -> uniform over legal actions, else visits^(1/T).
    `temperature` is a float or a per-lane [B] tensor. The draw is the
    Gumbel-max form of a categorical sample, as jax.random.categorical.
    """
    visits = visit_counts.to(torch.float32)
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=visits.device)
    if temperature.dim() == visits.dim() - 1:
        temperature = temperature[..., None]  # [B] -> [B, 1] broadcast
    t_safe = torch.where(
        (temperature <= 0) | ~torch.isfinite(temperature), 1.0, temperature
    )
    powed = torch.where(legal_mask, visits ** (1.0 / t_safe), 0.0)
    powed = powed / torch.clamp(torch.sum(powed, dim=-1, keepdim=True), min=1e-30)
    uniform = legal_mask.to(torch.float32)
    uniform = uniform / torch.clamp(torch.sum(uniform, dim=-1, keepdim=True),
                                    min=1e-30)
    greedy = torch.nn.functional.one_hot(
        torch.argmax(torch.where(legal_mask, visits, -1.0), dim=-1),
        visits.shape[-1],
    ).to(torch.float32)
    probs = torch.where(
        temperature == 0,
        greedy,
        torch.where(torch.isinf(temperature), uniform, powed),
    )
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(torch.log(probs + 1e-30) + gumbel, dim=-1)


def visit_policy(visit_counts):
    """Normalized visit distribution over the full action space
    (reference GameHistory.store_search_statistics, self_play.py:496-509)."""
    v = visit_counts.to(torch.float32)
    return v / torch.clamp(torch.sum(v, dim=-1, keepdim=True), min=1e-30)


# ---------------------------------------------------------------------------
# The staged search
# ---------------------------------------------------------------------------


def init_tree(N, root_prior, legal_mask, to_play, root_reward) -> Tree:
    """Fresh node-major Tree with the root (node 0) expanded
    (self_play.py:279-314)."""
    B, A = legal_mask.shape
    dev = legal_mask.device
    children_prior = torch.zeros((B, N, A), dtype=torch.float32, device=dev)
    children_prior[:, 0] = root_prior
    return Tree(
        children_index=torch.full((B, N, A), -1, dtype=torch.int32, device=dev),
        children_prior=children_prior,
        children_visit=torch.zeros((B, N, A), dtype=torch.int32, device=dev),
        children_vsum=torch.zeros((B, N, A), dtype=torch.float32, device=dev),
        children_reward=torch.zeros((B, N, A), dtype=torch.float32, device=dev),
        root_legal=legal_mask.to(torch.bool),
        root_visit=torch.zeros((B,), dtype=torch.int32, device=dev),
        root_vsum=torch.zeros((B,), dtype=torch.float32, device=dev),
        root_reward=root_reward.to(torch.float32).contiguous(),
        root_to_play=to_play.to(torch.int32),
        min_value=torch.full((B,), math.inf, device=dev),
        max_value=torch.full((B,), -math.inf, device=dev),
    )


def _to_planar(tree: Tree) -> Tree:
    """[B, N, A] edge slabs <-> [B, A, N] planar slabs (an involution): the
    kernels read one [B, N] plane per action. Once per move each way."""

    def t(x):
        return x.transpose(1, 2).contiguous()

    return tree._replace(
        children_index=t(tree.children_index),
        children_prior=t(tree.children_prior),
        children_visit=t(tree.children_visit),
        children_vsum=t(tree.children_vsum),
        children_reward=t(tree.children_reward),
    )


_from_planar = _to_planar


def edge_stats(tree: Tree, node):
    """The A edge rows of `node` [B] of a node-major tree: (visit f32,
    vsum, reward, prior), one gather each."""
    b_idx = torch.arange(node.shape[0], device=node.device)
    cvis = tree.children_visit[b_idx, node].to(torch.float32)
    cvsum = tree.children_vsum[b_idx, node]
    crew = tree.children_reward[b_idx, node]
    cprior = tree.children_prior[b_idx, node]
    return cvis, cvsum, crew, cprior


def _normalize(tree: Tree, q):
    """MinMaxStats.normalize over [B, A] q values (self_play.py:566-570)."""
    mn = tree.min_value[:, None]
    mx = tree.max_value[:, None]
    return torch.where(mx > mn, (q - mn) / torch.clamp(mx - mn, min=1e-30), q)


def _random_argmax(generator, scores):
    """Uniform choice among the entries equal to the row max
    (self_play.py:371-377), from `generator`."""
    winners = scores >= torch.amax(scores, dim=-1, keepdim=True)
    u = torch.rand(scores.shape, generator=generator, device=scores.device)
    return torch.argmax(torch.where(winners, u, -1.0), dim=-1)


def _ucb_scores(tree: Tree, node, spec: SearchSpec):
    """Vectorized pUCT over the A child edges of `node` [B] of a node-major
    tree (self_play.py:380-404). Returns (scores, cvis, cvsum, crew)."""
    cvis, cvsum, crew, cprior = edge_stats(tree, node)
    parent_visit = torch.sum(cvis, dim=-1) + (node != 0).to(torch.float32)
    child_value = torch.where(cvis > 0, cvsum / torch.clamp(cvis, min=1.0), 0.0)
    base = torch.tensor(spec.pb_c_base, device=cvis.device)  # a true division
    pb_c = torch.log((parent_visit + spec.pb_c_base + 1.0) / base) + spec.pb_c_init
    pb_c = pb_c[:, None] * torch.sqrt(parent_visit)[:, None] / (cvis + 1.0)
    prior_score = pb_c * cprior
    sign = 1.0 if spec.num_players == 1 else -1.0
    q = crew + spec.discount * sign * child_value
    value_score = torch.where(cvis > 0, _normalize(tree, q), 0.0)
    scores = prior_score + value_score
    # At the root only legal actions are candidate children.
    at_root = (node == 0)[:, None]
    scores = torch.where(at_root & ~tree.root_legal, -math.inf, scores)
    return scores, cvis, cvsum, crew


class SelectOut(NamedTuple):
    """One descent. path_stats ([B, D, 3]: each selected edge's reward,
    visit and vsum) comes from the plain-op route with capture on."""

    parent: torch.Tensor  # [B]
    action: torch.Tensor  # [B]
    path_nodes: torch.Tensor  # [B, D] node at depth t, -1 padded
    path_actions: torch.Tensor  # [B, D] action taken from it, 0 padded
    leaf_depth: torch.Tensor  # [B] edges from the root to the new leaf
    path_stats: Optional[torch.Tensor] = None


def _select_leaf(tree: Tree, generator, spec: SearchSpec, depth_bound, sim: int,
                 seed: int, legal_i32=None, plain_kernels=False,
                 mark_visits=False) -> SelectOut:
    """Descend all B trees to an unexpanded edge.

    depth_bound: a 0-d int32 device tensor, at least the longest descent
    any lane can need. The kernel route (planar tree) hands it to the
    kernel, which reads it on the card; the plain-op route (node-major tree)
    loops that many levels with finished lanes masked. `seed` keys the
    kernel route's tie jitter, at simulation `sim`; `plain_kernels` runs the
    kernels' plain versions instead (the card comparisons). mark_visits
    (kernel route, multi-leaf rounds): the descent adds +1 to the visit of
    every edge it takes, in place on tree.children_visit."""
    if spec.use_kernels:
        descend = (mcts_kernels.descend_planar_plain if plain_kernels
                   else mcts_kernels.descend_planar)
        parent, action, leaf_depth, path_n, path_a = descend(
            seed, sim, depth_bound, tree.children_index, tree.children_prior,
            tree.children_visit, tree.children_vsum, tree.children_reward,
            legal_i32, tree.min_value, tree.max_value,
            num_players=spec.num_players, pb_c_base=spec.pb_c_base,
            pb_c_init=spec.pb_c_init, discount=spec.discount,
            max_depth=spec.max_depth, tie_jitter=spec.tie_jitter,
            mark_visits=mark_visits,
        )
        return SelectOut(parent, action, path_n, path_a, leaf_depth)

    B = tree.children_index.shape[0]
    dev = tree.children_index.device
    b_idx = torch.arange(B, device=dev)
    D = spec.max_depth + 1
    path_n = torch.full((B, D), -1, dtype=torch.int32, device=dev)
    path_n[:, 0] = 0
    path_a = torch.zeros((B, D), dtype=torch.int32, device=dev)
    path_s = (torch.zeros((B, D, 3), device=dev) if spec.capture_path_stats
              else None)
    current = torch.zeros((B,), dtype=torch.long, device=dev)
    depth = torch.zeros((B,), dtype=torch.long, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    parent = torch.zeros_like(current)
    action = torch.zeros_like(current)
    for _ in range(min(int(depth_bound), spec.max_depth)):
        scores, cvis, cvsum, crew = _ucb_scores(tree, current, spec)
        if spec.deterministic_tie_break:
            sel = torch.argmax(scores, dim=-1)  # the first max
        else:
            sel = _random_argmax(generator, scores)
        path_a[b_idx, depth] = torch.where(active, sel, path_a[b_idx, depth]).to(torch.int32)
        if path_s is not None:
            sel_stats = torch.stack(
                [crew[b_idx, sel], cvis[b_idx, sel], cvsum[b_idx, sel]], dim=-1
            )
            path_s[b_idx, depth] = torch.where(active[:, None], sel_stats,
                                               path_s[b_idx, depth])
        child = tree.children_index[b_idx, current, sel].long()
        hits_leaf = active & (child < 0)
        parent = torch.where(hits_leaf, current, parent)
        action = torch.where(hits_leaf, sel, action)
        active = active & (child >= 0)
        current = torch.where(active, child, current)
        depth = depth + active.long()
        path_n[b_idx, depth] = torch.where(active, current, path_n[b_idx, depth]).to(torch.int32)
    # The new node sits one edge below the deepest recorded node.
    return SelectOut(parent, action, path_n, path_a, (depth + 1).to(torch.int32),
                     path_stats=path_s)


def _expand_and_backprop(tree: Tree, hidden, sim: int, spec: SearchSpec,
                         recurrent_fn, s: SelectOut, plain_kernels=False):
    """Expand node sim + 1 below each lane's (parent, action), write its
    hidden row, and back its value up. Updates `tree` and `hidden` in place.

    The leaf edge's reward is written BEFORE the backprop reads it."""
    B = tree.children_index.shape[0]
    b_idx = torch.arange(B, device=hidden.device)
    new_node = sim + 1
    parent, action = s.parent.long(), s.action.long()

    # ---- Expansion: one batched recurrent inference ----------------------
    value_logits, reward_logits, policy_logits, hidden_leaf = recurrent_fn(
        hidden[parent, b_idx], action
    )
    leaf_value = support_to_scalar(value_logits, spec.support_size).contiguous()
    leaf_reward = support_to_scalar(reward_logits, spec.support_size)
    # Interior nodes expand over the FULL action space (self_play.py:345-351).
    prior_leaf = torch.softmax(policy_logits, dim=-1)
    hidden[new_node] = hidden_leaf
    if spec.use_kernels:
        # Planar slabs: edge (parent, action) at [b, action, parent], node
        # new_node's prior row is column new_node of every action plane.
        tree.children_index[b_idx, action, parent] = new_node
        tree.children_reward[b_idx, action, parent] = leaf_reward
        tree.children_prior[:, :, new_node] = prior_leaf
        backprop = mcts_kernels.backprop_plain if plain_kernels else mcts_kernels.backprop
        backprop(
            s.path_nodes, s.path_actions, s.leaf_depth, leaf_value,
            tree.children_visit, tree.children_vsum, tree.children_reward,
            tree.root_visit, tree.root_vsum, tree.root_reward,
            tree.min_value, tree.max_value,
            num_players=spec.num_players, discount=spec.discount, planar=True,
        )
        return s.leaf_depth

    tree.children_index[b_idx, parent, action] = new_node
    tree.children_reward[b_idx, parent, action] = leaf_reward
    tree.children_prior[:, new_node] = prior_leaf
    path_stats = s.path_stats
    if path_stats is not None:
        # The leaf edge's reward was 0 at descent time (unexpanded): patch
        # the decoded one in, as a post-expansion gather would read it.
        path_stats[b_idx, s.leaf_depth.long() - 1, 0] = leaf_reward
    _backprop_vectorized(tree, s.path_nodes, s.path_actions, s.leaf_depth,
                         leaf_value, spec, path_stats=path_stats)
    return s.leaf_depth


def _interleave(a, b, dim):
    """Elements of a at even and of b at odd positions along dim
    (len(a) - len(b) in {0, 1}), as jax.lax's associative_scan does."""
    shape = list(a.shape)
    shape[dim] += b.shape[dim]
    out = a.new_empty(shape)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = a
    out[(slice(None),) * dim + (slice(1, None, 2),)] = b
    return out


def associative_scan(fn: Callable, elems, reverse=False, dim=0):
    """jax.lax.associative_scan for a tuple of tensors, with its recursion
    (odd/even halving) and so its order of combinations: fn(a, b) combines
    the earlier elements a with the later b."""
    if reverse:
        elems = tuple(e.flip(dim) for e in elems)

    def sl(e, start, stop=None, step=1):
        return e[(slice(None),) * dim + (slice(start, stop, step),)]

    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                     tuple(sl(e, 1, None, 2) for e in elems))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(sl(e, 0, -1) for e in odd),
                      tuple(sl(e, 2, None, 2) for e in elems))
        else:
            even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
        even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even))
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    out = scan(tuple(elems))
    if reverse:
        out = tuple(e.flip(dim) for e in out)
    return out


def _backprop_vectorized(tree: Tree, path_nodes, path_actions, leaf_depth,
                         leaf_value, spec: SearchSpec, planar=False,
                         path_stats=None):
    """Whole-path backprop with no sequential walk, in place on `tree`
    (JAX ops/mcts.py _backprop_vectorized).

    The values propagated to each depth, v(t) = s_{t+1} r_{t+1} + discount *
    v(t+1) with v(L) = leaf value, come from one reverse associative scan
    over the path; the edge updates are two scatter-adds; min/max take the
    post-update node stats in one masked reduce. planar: the slabs are
    [B, A, N]. path_stats [..., D, 3] (captured by the descent, leaf-edge
    reward patched): used instead of gathering the slabs.

    Multi-leaf rounds pass path_nodes, path_actions [K, B, D] and
    leaf_depth, leaf_value [K, B]: the paths' visits and the roots' were
    already counted by virtual marks (JAX's pre_marked), so only value sums
    are added and the visit counts read are taken as the post-update ones;
    all K paths fold in with one pair of scatter-adds, and each path's node
    values are taken against the value sums from before the round, as in
    the JAX package.
    """
    pre_marked = path_nodes.dim() == 3
    dev = path_nodes.device
    if pre_marked:
        K, B, D = path_nodes.shape
        path_nodes = path_nodes.reshape(K * B, D)
        path_actions = path_actions.reshape(K * B, D)
        leaf_depth = leaf_depth.reshape(K * B)
        leaf_value = leaf_value.reshape(K * B)
        bcol = torch.arange(B, device=dev).repeat(K)[:, None]
    else:
        K = 1
        B, D = path_nodes.shape
        bcol = torch.arange(B, device=dev)[:, None]
    M = K * B
    t_idx = torch.arange(D, device=dev)[None, :]
    L = leaf_depth.long()[:, None]
    sign = 1.0 if spec.num_players == 1 else -1.0

    # Edge j = (path_nodes[j], path_actions[j]) leads to the node at depth
    # j + 1 and exists for j < L; the padding beyond is clamped and masked.
    edge_mask = t_idx < L
    pn = torch.where(edge_mask, path_nodes, 0).long()
    pa = torch.where(edge_mask, path_actions, 0).long()
    i1, i2 = (pa, pn) if planar else (pn, pa)
    if path_stats is not None:
        ps = path_stats.reshape(M, D, 3)
        r_edge = torch.where(edge_mask, ps[..., 0], 0.0)
        ev_old = torch.where(edge_mask, ps[..., 1], 0.0)
        es_old = torch.where(edge_mask, ps[..., 2], 0.0)
    else:
        r_edge = tree.children_reward[bcol, i1, i2]
        ev_old = tree.children_visit[bcol, i1, i2].to(torch.float32)
        es_old = tree.children_vsum[bcol, i1, i2]

    # node_to_play == the leaf's player <=> t == L (mod num_players)
    if spec.num_players == 1:
        same = torch.ones((M, D), dtype=torch.bool, device=dev)
        s_next = torch.ones((M, D), device=dev)
    else:
        same = ((L - t_idx) % 2) == 0
        s_next = torch.where(((L - (t_idx + 1)) % 2) == 0, -1.0, 1.0)

    # v(t) by a reverse scan of the affine maps f_t(x) = a_t x + b_t:
    #   t < L: a = discount, b = s_{t+1} reward_{t+1}; t == L: a = 0, b =
    #   leaf value; t > L: a = b = 0 (masked later).
    a_coef = torch.where(edge_mask, spec.discount, 0.0)
    b_coef = torch.where(edge_mask, s_next * r_edge,
                         torch.where(t_idx == L, leaf_value[:, None], 0.0))

    def compose(acc, elem):
        # Reversed, `acc` holds the higher depths and `elem` the lower:
        # the result is f_elem(f_acc(x)).
        a_l, b_l = acc
        a_r, b_r = elem
        return a_r * a_l, a_r * b_l + b_r

    _, v = associative_scan(compose, (a_coef, b_coef), reverse=True, dim=1)

    node_mask = t_idx <= L
    delta = torch.where(same, v, -v)  # value-sum contribution at depth t

    # ---- min/max over the post-update node stats (pre-update reads) -----
    # The node at depth t >= 1 owns edge t-1's stats; depth 0 is the root.
    def node_shift(edge_arr, root_col):
        return torch.cat([root_col.repeat(K)[:, None], edge_arr[:, :-1]], dim=1)

    visit_inc = 0.0 if pre_marked else 1.0
    nvis = node_shift(ev_old, tree.root_visit.to(torch.float32)) + visit_inc
    nsum = node_shift(es_old, tree.root_vsum)
    nrew = node_shift(r_edge, tree.root_reward)
    node_val = (nsum + delta) / torch.clamp(nvis, min=1.0)
    stat = nrew + spec.discount * sign * node_val
    big = torch.finfo(torch.float32).max
    stat_min = torch.amin(torch.where(node_mask, stat, big), dim=1)
    stat_max = torch.amax(torch.where(node_mask, stat, -big), dim=1)
    delta0 = delta[:, 0]
    if pre_marked:
        stat_min = stat_min.reshape(K, B).amin(0)
        stat_max = stat_max.reshape(K, B).amax(0)
        delta0 = delta0.reshape(K, B).sum(0)

    # ---- scatters: edge j gets node (j+1)'s delta (repeated targets of the
    # K paths accumulate) -------------------------------------------------
    edge_delta = torch.cat([delta[:, 1:], torch.zeros((M, 1), device=dev)], dim=1)
    bidx = bcol.expand(M, D)
    tree.children_vsum.index_put_(
        (bidx, i1, i2), torch.where(edge_mask, edge_delta, 0.0), accumulate=True)
    if not pre_marked:
        tree.children_visit.index_put_(
            (bidx, i1, i2), edge_mask.to(torch.int32), accumulate=True)
        tree.root_visit.add_(1)
    tree.root_vsum.add_(delta0)
    torch.minimum(tree.min_value, stat_min, out=tree.min_value)
    torch.maximum(tree.max_value, stat_max, out=tree.max_value)


def _apply_virtual_marks(tree: Tree, path_nodes, path_actions, leaf_depth, planar=False):
    """Virtual-visit marking (JAX ops/mcts.py:806-827): +1 visit on every
    edge of each lane's path and on its root, in place, between the K
    selections of a multi-leaf round, so the later ones are steered away
    from leaves in flight; their backprops then run pre-marked. planar: the
    slabs are [B, A, N]."""
    B, D = path_nodes.shape
    bcol = torch.arange(B, device=path_nodes.device)[:, None].expand(B, D)
    t_idx = torch.arange(D, device=path_nodes.device)[None, :]
    edge_mask = t_idx < leaf_depth.long()[:, None]
    pn = torch.where(edge_mask, path_nodes, 0).long()
    pa = torch.where(edge_mask, path_actions, 0).long()
    i1, i2 = (pa, pn) if planar else (pn, pa)
    tree.children_visit.index_put_((bcol, i1, i2), edge_mask.to(torch.int32),
                                   accumulate=True)
    tree.root_visit.add_(1)


def _run_rounds_multileaf(tree: Tree, hidden, spec: SearchSpec, recurrent_fn, steps: int,
                          generator, seed, legal_i32, plain_kernels: bool):
    """steps / K rounds of K leaves each (JAX ops/mcts.py:830-1005), in
    place on `tree` and `hidden`. Per round:

    1. K selections with virtual-visit marks between them: in the descend
       kernel on the kernel route (the root's counter outside it, JAX
       :891-896), by _apply_virtual_marks on the plain-op route, whose
       captured path stats are taken before the selection's own mark;
    2. one gather of the K parents' hidden rows and one recurrent inference
       over the K * B leaves; their hidden rows written at once;
    3. one batched expansion of nodes r*K+1 .. r*K+K. A selection that takes
       the same unexpanded edge as an earlier one of its round does not
       expand it again: it writes onto its own node row (a self-loop at
       action 0 of a node nothing links to, JAX :931-952), keeping its value
       credit in the backprop;
    4. the backprop with the visits pre-marked: K backprop launches on the
       kernel route (JAX :955-979); on the plain-op route one multi-path
       _backprop_vectorized, each path's leaf-edge reward patched with its
       own network reward (JAX :981-995).

    Returns the max tree depth [B]."""
    K = spec.batch_leaves
    B, A = tree.root_legal.shape
    dev = hidden.device
    b_idx = torch.arange(B, device=dev)
    bcol = b_idx[None].expand(K, B)
    planar = spec.use_kernels
    max_depth = torch.zeros((B,), dtype=torch.int32, device=dev)
    backprop = mcts_kernels.backprop_plain if plain_kernels else mcts_kernels.backprop
    for r in range(steps // K):
        # A round's selections see no new expansions: one bound serves all K.
        depth_bound = torch.amax(max_depth) + 1
        sels = []
        for k in range(K):
            sim = r * K + k
            if spec.use_kernels:
                s = _select_leaf(tree, generator, spec, depth_bound, sim, seed, legal_i32,
                                 plain_kernels, mark_visits=True)
                tree.root_visit.add_(1)
            else:
                s = _select_leaf(tree, generator, spec, depth_bound, sim, seed)
                _apply_virtual_marks(tree, s.path_nodes, s.path_actions, s.leaf_depth)
            sels.append(s)
        parents = torch.stack([s.parent for s in sels]).long()  # [K, B]
        actions = torch.stack([s.action for s in sels]).long()
        leaf_depth = torch.stack([s.leaf_depth for s in sels])  # [K, B]

        # ---- one hidden gather, one recurrent inference -------------------
        ph = hidden[parents, bcol]  # [K, B, ...]
        value_logits, reward_logits, policy_logits, h2 = recurrent_fn(
            ph.reshape((K * B,) + tuple(ph.shape[2:])), actions.reshape(-1))
        leaf_values = support_to_scalar(value_logits, spec.support_size).reshape(K, B)
        leaf_rewards = support_to_scalar(reward_logits, spec.support_size).reshape(K, B)
        priors = torch.softmax(policy_logits, dim=-1).reshape(K, B, A)
        new_nodes = r * K + 1 + torch.arange(K, device=dev)
        hidden[new_nodes] = h2.reshape((K, B) + tuple(h2.shape[1:]))

        # ---- duplicate selections: the first of a round keeps the edge ----
        eid = parents * A + actions
        keep = torch.ones((K, B), dtype=torch.bool, device=dev)
        for k in range(1, K):
            keep[k] = ~(eid[:k] == eid[k]).any(0)

        # ---- one batched expansion ----------------------------------------
        nn2 = new_nodes[:, None].expand(K, B)
        p_t = torch.where(keep, parents, nn2)
        a_t = torch.where(keep, actions, 0)
        i1, i2 = (a_t, p_t) if planar else (p_t, a_t)
        tree.children_index[bcol, i1, i2] = nn2.to(torch.int32)
        tree.children_reward[bcol, i1, i2] = torch.where(keep, leaf_rewards, 0.0)
        if planar:
            tree.children_prior[:, :, new_nodes] = priors.permute(1, 2, 0)
        else:
            tree.children_prior[:, new_nodes] = priors.permute(1, 0, 2)

        # ---- the backprop of the K paths, visits pre-marked ----------------
        if spec.use_kernels:
            for k, s in enumerate(sels):
                backprop(
                    s.path_nodes, s.path_actions, s.leaf_depth, leaf_values[k],
                    tree.children_visit, tree.children_vsum, tree.children_reward,
                    tree.root_visit, tree.root_vsum, tree.root_reward,
                    tree.min_value, tree.max_value,
                    num_players=spec.num_players, discount=spec.discount, planar=True,
                    pre_marked=True,
                )
        else:
            ps = None
            if sels[0].path_stats is not None:
                ps = torch.stack([s.path_stats for s in sels])  # [K, B, D, 3]
                kcol = torch.arange(K, device=dev)[:, None]
                ps[kcol, bcol, leaf_depth.long() - 1, 0] = leaf_rewards
            _backprop_vectorized(
                tree, torch.stack([s.path_nodes for s in sels]),
                torch.stack([s.path_actions for s in sels]), leaf_depth, leaf_values, spec,
                path_stats=ps)
        max_depth = torch.maximum(max_depth, torch.amax(leaf_depth, 0))
    return max_depth


def _run_stream(tree: Tree, hidden, max_depth, spec: SearchSpec, recurrent_fn, steps: int,
                seed: int, legal_i32, plain_kernels: bool):
    """The stream route's simulations (JAX ops/mcts.py:1077-1152): the tree
    packed into one slab for the move, then per simulation the stream
    descent, the parent's hidden row, one recurrent inference, the expansion
    writes on the slab, the leaf edge's reward patched into the captured
    path stats, and the depth-major backprop. Returns (node-major tree,
    max_depth [B])."""
    # Imported here: ops/mcts_stream.py builds on this module's scan.
    from muzero_general_tpu_torch.ops import mcts_stream

    B, A = tree.root_legal.shape
    dev = hidden.device
    b_idx = torch.arange(B, device=dev)
    if plain_kernels:
        descend = mcts_stream.descend_stream_plain
    else:
        descend = mcts_stream.descend_stream
    edges = mcts_stream.pack_tree(tree, A)
    for sim in range(steps):
        depth_bound = torch.amax(max_depth) + 1  # stays on the device
        parent, action, leaf_depth, path_n, path_a, path_stats = descend(
            seed, sim, depth_bound, edges, legal_i32, tree.min_value, tree.max_value,
            num_players=spec.num_players, pb_c_base=spec.pb_c_base,
            pb_c_init=spec.pb_c_init, discount=spec.discount, A=A,
            max_depth=spec.max_depth, tie_jitter=spec.tie_jitter,
        )
        new_node = sim + 1
        value_logits, reward_logits, policy_logits, hidden_leaf = recurrent_fn(
            hidden[parent.long(), b_idx], action.long()
        )
        leaf_value = support_to_scalar(value_logits, spec.support_size)
        leaf_reward = support_to_scalar(reward_logits, spec.support_size)
        hidden[new_node] = hidden_leaf
        mcts_stream.expand_packed(edges, parent, action, new_node, leaf_reward,
                                  torch.softmax(policy_logits, dim=-1), A)
        # The leaf edge's reward was 0 at descent time (unexpanded): patch
        # the decoded one in. The path arrays stay depth-major [D, B].
        path_stats[0][leaf_depth.long() - 1, b_idx] = leaf_reward
        mcts_stream.backprop_stream(tree, edges, path_n, path_a, leaf_depth, leaf_value,
                                    path_stats, spec, plain_kernels=plain_kernels)
        max_depth = torch.maximum(max_depth, leaf_depth)
    return mcts_stream.unpack_tree(tree, edges, A), max_depth


def run_mcts(
    initial_fn,
    recurrent_fn,
    observation,
    legal_mask,
    to_play,
    generator: Optional[torch.Generator],
    spec: SearchSpec,
    add_exploration_noise: bool = True,
    root_outputs=None,
    root_noise: Optional[torch.Tensor] = None,
    seed: Optional[int] = None,
    num_steps: Optional[int] = None,
    plain_kernels: bool = False,
) -> MCTSOutput:
    """Batched MCTS from `observation` [B, ...] (JAX ops/mcts.py run_mcts):
    one leaf per simulation, or multi-leaf rounds (spec.batch_leaves).

    initial_fn(obs) -> (value_logits, reward_logits, policy_logits, hidden);
    recurrent_fn(hidden, action) -> the same. legal_mask [B, A] bool: legal
    root actions; to_play [B] int32. root_outputs: a precomputed
    initial_fn result to seed the root. root_noise [B, A]: the Gamma draws
    of the Dirichlet noise (default: drawn from `generator`). seed: the
    kernel and stream routes' tie-jitter key (default: drawn from
    `generator`).
    num_steps: stop after that many of the spec's simulations (a mid-search
    tree; a multiple of spec.batch_leaves). plain_kernels: the kernel and stream routes run the kernels'
    plain versions (the card comparisons).
    """
    B, A = legal_mask.shape
    N = spec.num_simulations + 1
    dev = legal_mask.device

    value_logits, reward_logits, policy_logits, hidden0 = (
        root_outputs if root_outputs is not None else initial_fn(observation)
    )
    root_predicted_value = support_to_scalar(value_logits, spec.support_size)
    root_reward = support_to_scalar(reward_logits, spec.support_size)
    prior = masked_softmax(policy_logits, legal_mask)
    if add_exploration_noise:
        prior = add_root_noise(prior, legal_mask, spec.dirichlet_alpha,
                               spec.exploration_fraction, generator, root_noise)

    tree = init_tree(N, prior, legal_mask, to_play, root_reward)
    legal_i32 = None
    if spec.use_kernels or spec.use_stream:
        legal_i32 = legal_mask.to(torch.int32).contiguous()
        if seed is None:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                     device=dev))
    if spec.use_kernels:
        tree = _to_planar(tree)
    # Rows are written before they are read (node s+1 at simulation s).
    hidden = torch.empty((N,) + tuple(hidden0.shape), dtype=hidden0.dtype, device=dev)
    hidden[0] = hidden0
    max_depth = torch.zeros((B,), dtype=torch.int32, device=dev)
    steps = spec.num_simulations if num_steps is None else num_steps
    if spec.batch_leaves > 1:
        if steps % spec.batch_leaves:
            raise ValueError(f"num_steps={steps} is not a multiple of batch_leaves="
                             f"{spec.batch_leaves}")
        max_depth = _run_rounds_multileaf(tree, hidden, spec, recurrent_fn, steps, generator,
                                          seed, legal_i32, plain_kernels)
    elif spec.use_stream:
        tree, max_depth = _run_stream(tree, hidden, max_depth, spec, recurrent_fn, steps,
                                      seed, legal_i32, plain_kernels)
    else:
        for sim in range(steps):
            # A descent goes at most one edge below the deepest existing
            # node; the bound stays on the device.
            depth_bound = torch.amax(max_depth) + 1
            s = _select_leaf(tree, generator, spec, depth_bound, sim, seed,
                             legal_i32, plain_kernels)
            leaf_depth = _expand_and_backprop(tree, hidden, sim, spec, recurrent_fn,
                                              s, plain_kernels)
            # Edges descended including the final one to the new node, as
            # the reference's current_tree_depth (self_play.py:319-355).
            max_depth = torch.maximum(max_depth, leaf_depth)
    if spec.use_kernels:
        tree = _from_planar(tree)

    return MCTSOutput(
        root_visit_counts=tree.children_visit[:, 0],
        root_value=tree.root_value(),
        root_predicted_value=root_predicted_value,
        max_tree_depth=max_depth,
        tree=tree,
        root_hidden=hidden0,
    )
