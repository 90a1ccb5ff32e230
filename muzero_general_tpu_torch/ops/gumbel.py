"""Gumbel MuZero root action selection (port of ops/gumbel.py; opt-in,
`config.use_gumbel_mcts`).

"Policy improvement by planning with Gumbel" (Danihelka, Guez,
Schrittwieser & Silver, ICLR 2022): at the root, draw Gumbel variables,
spend the simulations by sequential halving over the candidates of
g + logits, and act by argmax g + logits + sigma(q_hat) among the
most-visited candidates. pUCT with Dirichlet noise (ops/mcts.py) stays the
default.

As in the JAX package, everything below the root reuses ops/mcts.py: the
node-major tree (`init_tree`, `edge_stats`), the expansion over the full
action space and the backprop with player signs and MinMaxStats
(`_expand_and_backprop` fed a SelectOut without path stats, so the backup
gathers from the slabs), with a SearchSpec on the plain-op route. The JAX
package runs no Pallas kernel on this search (its driver turns the fused
search off under Gumbel), so neither does the port: the descent is
PyTorch ops level by level on any device.

- The halving schedule is a static table, table[m][s] = the visit count a
  candidate must have to be considered at simulation s with m candidates
  in play; m = clip(num_legal, 1, min(max_considered, A)) per lane.
- Unvisited children's q are completed with the mixed value v_mix (paper
  eq. 7), normalized by min/max over the node's visited or legal children,
  and scaled by (c_visit + max_b N(b)) * c_scale.
- Below the root, nodes select argmax_a pi'(a) - N(a) / (1 + sum_b N(b))
  with pi' = softmax(logits + sigma(completed q)) over all A actions.
- The training target is pi' at the root over the legal actions.

The Gumbel draw [B, A] comes from `generator` (`sample_gumbel`), or is
injected through `gumbel` (tests hand in the JAX side's own draw).
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from muzero_general_tpu_torch.ops import mcts as mcts_ops
from muzero_general_tpu_torch.ops.support import support_to_scalar


class GumbelSpec(NamedTuple):
    """Static Gumbel-search hyperparameters (defaults from the paper/mctx)."""

    num_simulations: int
    num_players: int
    discount: float
    support_size: int
    max_depth: int
    max_considered_actions: int = 16
    c_visit: float = 50.0
    c_scale: float = 1.0

    @classmethod
    def from_config(cls, config):
        if len(config.players) > 2:
            raise NotImplementedError("More than two player mode not implemented.")
        return cls(
            num_simulations=config.num_simulations,
            num_players=len(config.players),
            discount=float(config.discount),
            support_size=config.support_size,
            max_depth=config.num_simulations,
            max_considered_actions=int(getattr(config, "gumbel_max_considered_actions", 16)),
            c_visit=float(getattr(config, "gumbel_c_visit", 50.0)),
            c_scale=float(getattr(config, "gumbel_c_scale", 1.0)),
        )

    def search_spec(self) -> mcts_ops.SearchSpec:
        """The SearchSpec of the shared expansion and backup (JAX
        gumbel.py:264-274): the plain-op route, one leaf a simulation."""
        return mcts_ops.SearchSpec(
            num_simulations=self.num_simulations,
            num_players=self.num_players,
            pb_c_base=19652.0,
            pb_c_init=1.25,
            discount=self.discount,
            dirichlet_alpha=0.0,
            exploration_fraction=0.0,
            support_size=self.support_size,
            max_depth=self.max_depth,
            use_kernels=False,
            use_stream=False,
            batch_leaves=1,
        )


class GumbelMCTSOutput(NamedTuple):
    action: torch.Tensor  # [B] sampled-exploration root action (gumbel argmax)
    greedy_action: torch.Tensor  # [B] argmax of the improved policy (eval)
    improved_policy: torch.Tensor  # [B, A] pi', the training policy target
    root_visit_counts: torch.Tensor  # [B, A] int32
    root_value: torch.Tensor  # [B]
    root_predicted_value: torch.Tensor  # [B]
    max_tree_depth: torch.Tensor  # [B] int32
    tree: mcts_ops.Tree


def sequence_of_considered_visits(num_considered: int, num_simulations: int):
    """Prescribed visit count per simulation under sequential halving.

    With m=num_considered candidates and n simulations: repeat phases of
    max(1, n / (log2(m) * m_phase)) extra visits per remaining candidate,
    halving the candidate set between phases (never below 2).
    """
    if num_considered <= 1:
        return tuple(range(num_simulations))
    log2m = max(1, int(math.ceil(math.log2(num_considered))))
    sequence = []
    visits = [0] * num_considered
    considered = num_considered
    while len(sequence) < num_simulations:
        extra = max(1, num_simulations // (log2m * considered))
        for _ in range(extra):
            sequence.extend(visits[:considered])
            for i in range(considered):
                visits[i] += 1
        considered = max(2, considered // 2)
    return tuple(sequence[:num_simulations])


def table_of_considered_visits(max_considered: int, num_simulations: int):
    """[max_considered+1, num_simulations] table, row m = schedule for m."""
    return np.array(
        [sequence_of_considered_visits(m, num_simulations)
         for m in range(max_considered + 1)],
        np.int32,
    )


def sample_gumbel(shape, generator: Optional[torch.Generator] = None, device=None):
    """Standard Gumbel draws -log(-log(u)) from `generator`, u uniform in
    (0, 1) (jax.random.gumbel's distribution)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def _children_q(tree: mcts_ops.Tree, node, spec: GumbelSpec):
    """Per-edge (visits int32, q, prior) of `node` [B]:
    q = reward + discount * sign * value, the pUCT value term's convention."""
    cvis, cvsum, crew, cprior = mcts_ops.edge_stats(tree, node)
    cval = torch.where(cvis > 0, cvsum / torch.clamp(cvis, min=1.0), 0.0)
    sign = 1.0 if spec.num_players == 1 else -1.0
    q = crew + spec.discount * sign * cval
    return cvis.to(torch.int32), q, cprior


def _completed_q_hat(visits, q, node_value, prior, legal, spec: GumbelSpec):
    """sigma(completed q) over [B, A] edges.

    Unvisited edges get v_mix = (v(node) + N * prior-weighted mean of the
    visited q) / (1 + N); all q are then min-max normalized over the node's
    visited or legal edges and scaled by (c_visit + max_b N(b)) * c_scale.
    """
    visited = visits > 0
    nvis = torch.sum(visits, dim=-1, keepdim=True).to(torch.float32)  # [B, 1]
    w = torch.where(visited, prior, 0.0)
    wsum = torch.sum(w, dim=-1, keepdim=True)
    q_avg = torch.sum(w * q, dim=-1, keepdim=True) / torch.clamp(wsum, min=1e-30)
    v_mix = (node_value[:, None] + nvis * q_avg) / (1.0 + nvis)
    # Nothing visited yet: the node's own value.
    v_mix = torch.where(wsum > 0, v_mix, node_value[:, None])
    completed = torch.where(visited, q, v_mix)

    big = torch.finfo(torch.float32).max
    consider = visited | legal
    q_min = torch.amin(torch.where(consider, completed, big), dim=-1, keepdim=True)
    q_max = torch.amax(torch.where(consider, completed, -big), dim=-1, keepdim=True)
    q_hat = (completed - q_min) / torch.clamp(q_max - q_min, min=1e-8)
    q_hat = torch.where(q_max > q_min, q_hat, completed)

    max_visit = torch.amax(visits, dim=-1, keepdim=True).to(torch.float32)
    return (spec.c_visit + max_visit) * spec.c_scale * q_hat


def _improved_logits(tree: mcts_ops.Tree, node, node_value, legal, spec: GumbelSpec):
    """(logits + sigma(completed q), visits) for the A edges of `node` [B]."""
    visits, q, prior = _children_q(tree, node, spec)
    sigma_q = _completed_q_hat(visits, q, node_value, prior, legal, spec)
    return torch.log(torch.clamp(prior, min=1e-30)) + sigma_q, visits


def _select_leaf_gumbel(tree: mcts_ops.Tree, spec: GumbelSpec, gumbel, prescribed,
                        trip: int) -> mcts_ops.SelectOut:
    """One descent (JAX gumbel.py:195-262): the halving-scheduled root pick,
    then the deterministic interior rule, for `trip` levels with finished
    lanes masked. The node value starts at the root's value() and becomes
    the taken edge's mean value on each step down."""
    B = tree.children_index.shape[0]
    dev = tree.children_index.device
    b_idx = torch.arange(B, device=dev)
    D = spec.max_depth + 1
    path_n = torch.full((B, D), -1, dtype=torch.int32, device=dev)
    path_n[:, 0] = 0
    path_a = torch.zeros((B, D), dtype=torch.int32, device=dev)
    current = torch.zeros((B,), dtype=torch.long, device=dev)
    node_value = tree.root_value()
    depth = torch.zeros((B,), dtype=torch.long, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    parent = torch.zeros_like(current)
    action = torch.zeros_like(current)
    sign = 1.0 if spec.num_players == 1 else -1.0
    for _ in range(trip):
        at_root = current == 0
        legal = tree.root_legal | ~at_root[:, None]
        cvis_f, cvsum, crew, cprior = mcts_ops.edge_stats(tree, current)
        visits = cvis_f.to(torch.int32)
        cval = torch.where(cvis_f > 0, cvsum / torch.clamp(cvis_f, min=1.0), 0.0)
        q = crew + spec.discount * sign * cval
        sigma_q = _completed_q_hat(visits, q, node_value, cprior, legal, spec)
        imp_logits = torch.log(torch.clamp(cprior, min=1e-30)) + sigma_q

        # Root: among the candidates whose visits equal the prescribed
        # count (else every legal action), argmax g + logits + sigma(q_hat).
        considered = legal & (visits == prescribed[:, None])
        has_match = torch.any(considered, dim=-1, keepdim=True)
        root_score = torch.where(torch.where(has_match, considered, legal),
                                 gumbel + imp_logits, -math.inf)
        sel_root = torch.argmax(root_score, dim=-1)
        # Interior: argmax pi'(a) - N(a) / (1 + sum_b N(b)) (paper sec. 5).
        pi_prime = torch.softmax(imp_logits, dim=-1)
        nvis = torch.sum(visits, dim=-1, keepdim=True).to(torch.float32)
        sel_int = torch.argmax(pi_prime - visits.to(torch.float32) / (1.0 + nvis), dim=-1)

        sel = torch.where(at_root, sel_root, sel_int)
        path_a[b_idx, depth] = torch.where(active, sel, path_a[b_idx, depth]).to(torch.int32)
        child = tree.children_index[b_idx, current, sel].long()
        hits_leaf = active & (child < 0)
        parent = torch.where(hits_leaf, current, parent)
        action = torch.where(hits_leaf, sel, action)
        active = active & (child >= 0)
        current = torch.where(active, child, current)
        # The edge's statistics are the child's node statistics.
        node_value = torch.where(active, cval[b_idx, sel], node_value)
        depth = depth + active.long()
        path_n[b_idx, depth] = torch.where(active, current, path_n[b_idx, depth]).to(torch.int32)
    return mcts_ops.SelectOut(parent, action, path_n, path_a, (depth + 1).to(torch.int32))


def run_gumbel_mcts(
    initial_fn,
    recurrent_fn,
    observation,
    legal_mask,
    to_play,
    generator: Optional[torch.Generator],
    spec: GumbelSpec,
    add_gumbel: bool = True,
    gumbel: Optional[torch.Tensor] = None,
) -> GumbelMCTSOutput:
    """Batched Gumbel MuZero search from `observation` [B, ...] (JAX
    ops/gumbel.py run_gumbel_mcts).

    initial_fn(obs) and recurrent_fn(hidden, action) return (value_logits,
    reward_logits, policy_logits, hidden); legal_mask [B, A] bool; to_play
    [B] int32. gumbel [B, A]: the root's Gumbel draw (default: drawn from
    `generator`). add_gumbel=False zeroes it (the deterministic greedy
    search of evaluation), the counterpart of pUCT's
    add_exploration_noise.
    """
    B, A = legal_mask.shape
    N = spec.num_simulations + 1
    dev = legal_mask.device
    legal_mask = legal_mask.to(torch.bool)

    value_logits, reward_logits, policy_logits, hidden0 = initial_fn(observation)
    root_predicted_value = support_to_scalar(value_logits, spec.support_size)
    root_reward = support_to_scalar(reward_logits, spec.support_size)
    prior = mcts_ops.masked_softmax(policy_logits, legal_mask)

    if not add_gumbel:
        gumbel = torch.zeros((B, A), device=dev)
    elif gumbel is None:
        gumbel = sample_gumbel((B, A), generator, dev)
    gumbel = torch.where(legal_mask, gumbel.to(device=dev, dtype=torch.float32), -math.inf)

    # Per-lane candidate count and its row of the static halving schedule.
    num_legal = torch.sum(legal_mask, dim=-1).to(torch.int32)
    m_cap = min(spec.max_considered_actions, A)
    num_considered = torch.clamp(num_legal, 1, m_cap).long()  # [B]
    table = torch.from_numpy(table_of_considered_visits(m_cap, spec.num_simulations)).to(dev)
    schedule = table[num_considered]  # [B, S]

    tree = mcts_ops.init_tree(N, prior, legal_mask, to_play, root_reward)
    # Rows are written before they are read (node s+1 at simulation s).
    hidden = torch.empty((N,) + tuple(hidden0.shape), dtype=hidden0.dtype, device=dev)
    hidden[0] = hidden0
    mcts_spec = spec.search_spec()
    max_depth = torch.zeros((B,), dtype=torch.int32, device=dev)
    deepest = 0  # max(max_depth), kept on the host
    for sim in range(spec.num_simulations):
        trip = min(deepest + 1, spec.max_depth)
        s = _select_leaf_gumbel(tree, spec, gumbel, schedule[:, sim], trip)
        leaf_depth = mcts_ops._expand_and_backprop(tree, hidden, sim, mcts_spec,
                                                   recurrent_fn, s)
        max_depth = torch.maximum(max_depth, leaf_depth)
        deepest = int(torch.amax(max_depth))

    root0 = torch.zeros((B,), dtype=torch.long, device=dev)
    root_value = tree.root_value()
    imp_logits, root_visits = _improved_logits(tree, root0, root_value, legal_mask, spec)

    # The improved policy pi' over the legal actions: the training target.
    improved_policy = mcts_ops.masked_softmax(imp_logits, legal_mask)
    greedy_action = torch.argmax(
        torch.where(legal_mask, improved_policy, -math.inf), dim=-1).to(torch.int32)
    # Acting: argmax g + logits + sigma(q_hat) among the most-visited legal
    # candidates.
    max_visit = torch.amax(root_visits, dim=-1, keepdim=True)
    final_score = torch.where(legal_mask & (root_visits == max_visit),
                              gumbel + imp_logits, -math.inf)
    action = torch.argmax(final_score, dim=-1).to(torch.int32)

    return GumbelMCTSOutput(
        action=action,
        greedy_action=greedy_action,
        improved_policy=improved_policy,
        root_visit_counts=root_visits,
        root_value=root_value,
        root_predicted_value=root_predicted_value,
        max_tree_depth=max_depth,
        tree=tree,
    )
