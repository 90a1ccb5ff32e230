"""Plain PyTorch reference of the batched MuZero search (muzero-general
self_play.py MCTS) as the program's staged search runs it on its kernel
route, and of the self-play driver's random draws.

- The search: pUCT with min-max normalised values (negated for two
  players), the root expanded over legal actions with Dirichlet noise,
  interior nodes over every action, a leaf-to-root backup with player signs
  and discount. Statistics live on edges in planar [B, A, N] slabs; exact
  score ties are broken by the descent's Philox tie jitter (philox.py).
  With `batch_leaves` K > 1 the simulations run in rounds: K descents that
  mark a virtual visit on every edge they take, one network call over the K
  leaves, a duplicate selection of a round writing onto its own orphan row,
  then K backups with the visits already counted. The descent and backup
  are frozen copies of the plain versions the program's kernels are held
  to, with their float32 operations in their order.
- The driver's draws (DriverStream): per move one tie-jitter key from the
  host generator, the root's Gamma draws (Marsaglia and Tsang's method on
  randn / rand) and the action sampler's uniforms from the device
  generator, both seeded with the driver's seed. The stream is replayed
  move by move in the program's order, so the reference sees the noise the
  program drew without taking it from the program.
"""

import math
from typing import NamedTuple

import torch

from gpubench.reference.philox import TIE_JITTER, U32_RANGE, jitter_bits
from gpubench.reference.resnet import support_to_scalar


class SearchSpec(NamedTuple):
    num_simulations: int
    num_players: int
    pb_c_base: float
    pb_c_init: float
    discount: float
    dirichlet_alpha: float
    exploration_fraction: float
    support_size: int
    batch_leaves: int = 1
    tie_jitter: float = TIE_JITTER

    @classmethod
    def from_config(cls, cfg):
        return cls(
            num_simulations=cfg["num_simulations"], num_players=len(cfg["players"]),
            pb_c_base=float(cfg["pb_c_base"]), pb_c_init=float(cfg["pb_c_init"]),
            discount=float(cfg["discount"]), dirichlet_alpha=float(cfg["root_dirichlet_alpha"]),
            exploration_fraction=float(cfg["root_exploration_fraction"]),
            support_size=cfg["support_size"], batch_leaves=cfg.get("search_batch_leaves", 1))


def masked_softmax(logits, mask):
    z = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    z = z - torch.amax(z, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(z), 0.0)
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)


def sample_gamma(alpha, shape, generator, device):
    """Gamma(alpha, 1) by Marsaglia and Tsang (ACM TOMS 26(3), 2000):
    rejection rounds of randn / rand until all are accepted; for alpha < 1 a
    Gamma(alpha + 1) draw times U^(1/alpha)."""
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
        out = torch.where(pending & accept, d * v, out)
        pending = pending & ~accept
        if not bool(pending.any()):
            break
    if boost:
        u = torch.rand(shape, generator=generator, device=device)
        out = out * torch.exp(torch.log(u) / alpha)
    return out


class MoveDraws(NamedTuple):
    key: int  # the descent's tie-jitter key
    gamma: torch.Tensor  # [G, A] the root noise's Gamma draws
    uniform: torch.Tensor  # [G, A] the action sampler's uniforms


class DriverStream:
    """The self-play driver's draws, move after move, from its seed."""

    def __init__(self, seed, lanes, num_actions, spec: SearchSpec, device, add_noise=True):
        self.host = torch.Generator().manual_seed(seed)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.shape = (lanes, num_actions)
        self.spec = spec
        self.device = device
        self.add_noise = add_noise

    def next_move(self) -> MoveDraws:
        key = int(torch.randint(0, 2**31 - 1, (1,), generator=self.host))
        gamma = None
        if self.add_noise:
            gamma = sample_gamma(self.spec.dirichlet_alpha, self.shape, self.gen, self.device)
        uniform = torch.rand(self.shape, generator=self.gen, device=self.device)
        return MoveDraws(key, gamma, uniform)


def sampled_action_gap(visits, legal, temperature, uniform):
    """How far below the best Gumbel-max score each lane's recorded action
    lies, for root visit counts `visits` [G, A] (int), sampled at
    `temperature` with the stream's `uniform` draw: (scores [G, A], the
    action the draw picks [G])."""
    v = visits.to(torch.float32)
    t = torch.as_tensor(temperature, dtype=torch.float32, device=v.device)
    if t.dim() == v.dim() - 1:
        t = t[..., None]
    t_safe = torch.where((t <= 0) | ~torch.isfinite(t), 1.0, t)
    powed = torch.where(legal, v ** (1.0 / t_safe), 0.0)
    powed = powed / torch.clamp(torch.sum(powed, dim=-1, keepdim=True), min=1e-30)
    uniform_p = legal.to(torch.float32)
    uniform_p = uniform_p / torch.clamp(torch.sum(uniform_p, dim=-1, keepdim=True), min=1e-30)
    greedy = torch.nn.functional.one_hot(
        torch.argmax(torch.where(legal, v, -1.0), dim=-1), v.shape[-1]).to(torch.float32)
    probs = torch.where(t == 0, greedy, torch.where(torch.isinf(t), uniform_p, powed))
    scores = torch.log(probs + 1e-30) - torch.log(-torch.log(uniform))
    return scores, torch.argmax(scores, dim=-1)


class Tree(NamedTuple):
    index: torch.Tensor  # [B, A, N] int32, -1 unexpanded
    prior: torch.Tensor  # [B, A, N]
    visit: torch.Tensor  # [B, A, N] int32
    vsum: torch.Tensor  # [B, A, N]
    reward: torch.Tensor  # [B, A, N]
    legal: torch.Tensor  # [B, A] bool, the root's
    root_visit: torch.Tensor  # [B] int32
    root_vsum: torch.Tensor  # [B]
    root_reward: torch.Tensor  # [B]
    min_value: torch.Tensor  # [B]
    max_value: torch.Tensor  # [B]


def descend(tree: Tree, spec: SearchSpec, seed, sim, depth_bound, mark_visits=False):
    """All B lanes from the root to an unexpanded edge: (parent, action,
    leaf_depth, path_nodes, path_actions). mark_visits: +1 on the visit of
    every edge a lane takes, after its level's scores."""
    B, A, N = tree.index.shape
    dev = tree.index.device
    D = spec.num_simulations + 1
    bound = min(int(depth_bound), D - 1)
    disc_sign = spec.discount * (1.0 if spec.num_players == 1 else -1.0)
    base_t = torch.tensor(spec.pb_c_base, device=dev)
    span_ok = (tree.max_value > tree.min_value)[:, None]
    inv_span = (1.0 / torch.clamp(tree.max_value - tree.min_value, min=1e-30))[:, None]
    mn = tree.min_value[:, None]
    iota_a = torch.arange(A, device=dev)
    b_idx = torch.arange(B, device=dev)
    if spec.tie_jitter > 0 and bound > 0:
        bits = jitter_bits(B, A, sim, bound, int(seed) & 0xFFFFFFFFFFFFFFFF, dev)
        jitter_scale = spec.tie_jitter / U32_RANGE
    current = torch.zeros((B,), dtype=torch.long, device=dev)
    depth = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    parent = torch.zeros_like(current)
    action = torch.zeros_like(current)
    path_n = torch.full((B, D), -1, dtype=torch.int32, device=dev)
    path_n[:, 0] = 0
    path_a = torch.zeros((B, D), dtype=torch.int32, device=dev)
    for t in range(bound):
        node = current[:, None, None].expand(B, A, 1)

        def take(slab):
            return slab.gather(2, node)[..., 0]

        cvis = take(tree.visit).to(torch.float32)
        cval = torch.where(cvis > 0, take(tree.vsum) / torch.clamp(cvis, min=1.0), 0.0)
        pvis = cvis.sum(1, keepdim=True) + (current != 0).to(torch.float32)[:, None]
        pb_c = (torch.log((pvis + spec.pb_c_base + 1.0) / base_t) + spec.pb_c_init
                ) * torch.sqrt(pvis) / (cvis + 1.0)
        q = take(tree.reward) + disc_sign * cval
        qn = torch.where(span_ok, (q - mn) * inv_span, q)
        score = pb_c * take(tree.prior) + torch.where(cvis > 0, qn, 0.0)
        score = torch.where((current == 0)[:, None] & ~tree.legal, float("-inf"), score)
        if spec.tie_jitter > 0:
            score = score + bits[:, t].to(torch.float32) * jitter_scale
        m = torch.amax(score, dim=1, keepdim=True)
        sel = torch.amin(torch.where(score >= m, iota_a, A), dim=1)
        path_a[:, t] = torch.where(active, sel, path_a[:, t])
        if mark_visits:
            tree.visit.index_put_((b_idx, sel, current), active.to(torch.int32), accumulate=True)
        child = take(tree.index).gather(1, sel[:, None])[:, 0].long()
        hits = active & (child < 0)
        parent = torch.where(hits, current, parent)
        action = torch.where(hits, sel, action)
        active = active & (child >= 0)
        current = torch.where(active, child, current)
        depth = depth + active.to(torch.int32)
        path_n[:, t + 1] = torch.where(active, current, path_n[:, t + 1]).to(torch.int32)
    leaf_depth = torch.where(active, -1, depth + 1).to(torch.int32)
    return parent, action, leaf_depth, path_n, path_a


def backprop(tree: Tree, spec: SearchSpec, path_nodes, path_actions, leaf_depth, leaf_value,
             pre_marked=False):
    """Fold each lane's leaf value from its leaf to the root, in place.
    pre_marked: the visits were counted by the marking descent, so none is
    added and a node's value divides by max(visit, 1)."""
    B, A, N = tree.visit.shape
    stride_n, stride_a = 1, N
    visit = tree.visit.view(B, -1)
    vsum = tree.vsum.view(B, -1)
    reward = tree.reward.reshape(B, -1)
    disc_sign = spec.discount * (1.0 if spec.num_players == 1 else -1.0)
    value = leaf_value.clone()
    mn, mx = tree.min_value.clone(), tree.max_value.clone()
    rvis, rvsum = tree.root_visit.clone(), tree.root_vsum.clone()
    L = leaf_depth.long()
    for t_rev in range(int(L.max()) + 1 if B else 0):
        t = L - t_rev
        valid = t >= 0
        at_root = valid & (t == 0)
        on_edge = valid & (t >= 1)
        sgn = 1.0 if spec.num_players == 1 or t_rev % 2 == 0 else -1.0
        delta = value * sgn
        prev = torch.clamp(t - 1, min=0)[:, None]
        e = (path_nodes.long().gather(1, prev) * stride_n
             + path_actions.long().gather(1, prev) * stride_a)
        ev_old = visit.gather(1, e)[:, 0]
        es_old = vsum.gather(1, e)[:, 0]
        es_new = es_old + delta
        vsum.scatter_(1, e, torch.where(on_edge, es_new, es_old)[:, None])
        rvsum = torch.where(at_root, rvsum + delta, rvsum)
        if pre_marked:
            denom = torch.clamp(ev_old.to(torch.float32), min=1.0)
        else:
            visit.scatter_(1, e, torch.where(on_edge, ev_old + 1, ev_old)[:, None])
            rvis = torch.where(at_root, rvis + 1, rvis)
            denom = ev_old.to(torch.float32) + 1.0
        nval = torch.where(at_root, rvsum / torch.clamp(rvis, min=1).to(torch.float32),
                           es_new / denom)
        nrew = torch.where(at_root, tree.root_reward, reward.gather(1, e)[:, 0])
        stat = nrew + disc_sign * nval
        mn = torch.where(valid, torch.minimum(mn, stat), mn)
        mx = torch.where(valid, torch.maximum(mx, stat), mx)
        if spec.num_players == 1:
            vnext = nrew + spec.discount * value
        else:
            vnext = -sgn * nrew + spec.discount * value
        value = torch.where(valid, vnext, value)
    tree.root_visit.copy_(rvis)
    tree.root_vsum.copy_(rvsum)
    tree.min_value.copy_(mn)
    tree.max_value.copy_(mx)


class SearchOut(NamedTuple):
    visits: torch.Tensor  # [B, A] int32 root visit counts
    root_value: torch.Tensor  # [B]
    predicted_value: torch.Tensor  # [B] the network's value at the root


def run(net, obs, legal, spec: SearchSpec, draws: MoveDraws) -> SearchOut:
    """One search of every lane from observations `obs` [B, ...] with legal
    root actions `legal` [B, A], the root noise and tie-jitter key of
    `draws`. `net` has initial_inference(obs) -> (value logits, policy
    logits, hidden) and recurrent_inference(hidden, action) -> (value,
    reward, policy logits, hidden)."""
    B, A = legal.shape
    S, N, K = spec.num_simulations, spec.num_simulations + 1, spec.batch_leaves
    dev = legal.device
    value_logits, policy_logits, hidden0 = net.initial_inference(obs)
    predicted = support_to_scalar(value_logits, spec.support_size)
    prior = masked_softmax(policy_logits, legal)
    if draws.gamma is not None:
        g = torch.where(legal, draws.gamma, 0.0)
        noise = g / torch.clamp(torch.sum(g, dim=-1, keepdim=True), min=1e-30)
        frac = spec.exploration_fraction
        prior = torch.where(legal, prior * (1 - frac) + noise * frac, 0.0)
    prior_slab = torch.zeros((B, A, N), device=dev)
    prior_slab[:, :, 0] = prior
    tree = Tree(
        index=torch.full((B, A, N), -1, dtype=torch.int32, device=dev),
        prior=prior_slab,
        visit=torch.zeros((B, A, N), dtype=torch.int32, device=dev),
        vsum=torch.zeros((B, A, N), device=dev),
        reward=torch.zeros((B, A, N), device=dev),
        legal=legal,
        root_visit=torch.zeros((B,), dtype=torch.int32, device=dev),
        root_vsum=torch.zeros((B,), device=dev),
        root_reward=torch.zeros((B,), device=dev),  # the initial inference's reward is 0
        min_value=torch.full((B,), math.inf, device=dev),
        max_value=torch.full((B,), -math.inf, device=dev),
    )
    hidden = torch.empty((N,) + tuple(hidden0.shape), dtype=hidden0.dtype, device=dev)
    hidden[0] = hidden0
    b_idx = torch.arange(B, device=dev)
    max_depth = torch.zeros((B,), dtype=torch.int32, device=dev)
    for r in range(S // K):
        depth_bound = torch.amax(max_depth) + 1
        sels = []
        for k in range(K):
            sels.append(descend(tree, spec, draws.key, r * K + k, depth_bound,
                                mark_visits=K > 1))
            if K > 1:
                tree.root_visit.add_(1)
        parents = torch.stack([s[0] for s in sels]).long()  # [K, B]
        actions = torch.stack([s[1] for s in sels]).long()
        leaf_depth = torch.stack([s[2] for s in sels])
        bcol = b_idx[None].expand(K, B)
        ph = hidden[parents, bcol]
        value_logits, reward_logits, policy_logits, h2 = net.recurrent_inference(
            ph.reshape((K * B,) + tuple(ph.shape[2:])), actions.reshape(-1))
        leaf_values = support_to_scalar(value_logits, spec.support_size).reshape(K, B)
        leaf_rewards = support_to_scalar(reward_logits, spec.support_size).reshape(K, B)
        priors = torch.softmax(policy_logits, dim=-1).reshape(K, B, A)
        new_nodes = r * K + 1 + torch.arange(K, device=dev)
        hidden[new_nodes] = h2.reshape((K, B) + tuple(h2.shape[1:]))
        # A selection repeating an earlier one of its round writes onto its
        # own node row (action 0 of a node nothing links to).
        eid = parents * A + actions
        keep = torch.ones((K, B), dtype=torch.bool, device=dev)
        for k in range(1, K):
            keep[k] = ~(eid[:k] == eid[k]).any(0)
        nn2 = new_nodes[:, None].expand(K, B)
        p_t = torch.where(keep, parents, nn2)
        a_t = torch.where(keep, actions, 0)
        tree.index[bcol, a_t, p_t] = nn2.to(torch.int32)
        tree.reward[bcol, a_t, p_t] = torch.where(keep, leaf_rewards, 0.0)
        tree.prior[:, :, new_nodes] = priors.permute(1, 2, 0)
        for k, (_, _, ld, pn, pa) in enumerate(sels):
            backprop(tree, spec, pn, pa, ld, leaf_values[k], pre_marked=K > 1)
        max_depth = torch.maximum(max_depth, torch.amax(leaf_depth, 0))
    v = tree.root_visit
    root_value = torch.where(v > 0, tree.root_vsum / torch.clamp(v, min=1), 0.0)
    return SearchOut(tree.visit[:, :, 0], root_value, predicted)
