"""Fully fused MCTS for FC networks: the whole search in one kernel launch.

Port of ops/mcts_fused.py. The JAX package runs the S-simulation search
(descend, FC recurrent inference, expand, backprop) in one Pallas kernel per
move (`_search_kernel`); here that kernel is hand-written CUDA
(csrc/mcts_fused.cu) and `search` is its wrapper. `search_plain` is the same
function in plain PyTorch: the wrapper uses it for CPU tensors only, and the
tests and chip_smoke.py hold the kernel against it.

Semantics are those of ops/mcts.py's staged search (reference
self_play.py:249-476): pUCT with min-max normalized values, illegal root
actions at -inf, a first-index argmax plus an optional <= 1e-5 uniform score
jitter that breaks exact ties at random, interior nodes expanded over the
full action space, backprop with player signs, discount and MinMaxStats.
Network details (reference models.py:147-170): dynamics input
concat(hidden, one_hot(action)) computed as a split first layer
h@W_h + onehot@W_a + b; the reward head reads the UNNORMALIZED dynamics
output; ELU MLPs with identity output; support decode = softmax ->
expectation -> h^-1.
"""

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from muzero_general_tpu_torch.ops import mcts as mcts_ops
from muzero_general_tpu_torch.ops.support import support_to_scalar

TIE_JITTER = 1e-5
_EPS = 0.001  # support codec epsilon (reference models.py:661,675)
_U32_RANGE = 4.2949673e9  # jitter scale divisor, as in the JAX kernel
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key increments (Weyl sequence)


class FusedSpec(NamedTuple):
    """Static parameters of the fused search (config groups of SURVEY §2.7)."""

    num_simulations: int
    num_players: int
    pb_c_base: float
    pb_c_init: float
    discount: float
    dirichlet_alpha: float
    exploration_fraction: float
    support_size: int
    encoding_size: int
    tie_jitter: float = TIE_JITTER

    @classmethod
    def from_config(cls, config, deterministic_tie_break=False):
        if len(config.players) > 2:
            raise NotImplementedError("More than two player mode not implemented.")
        return cls(
            num_simulations=config.num_simulations,
            num_players=len(config.players),
            pb_c_base=float(config.pb_c_base),
            pb_c_init=float(config.pb_c_init),
            discount=float(config.discount),
            dirichlet_alpha=float(config.root_dirichlet_alpha),
            exploration_fraction=float(config.root_exploration_fraction),
            support_size=config.support_size,
            encoding_size=config.encoding_size,
            tie_jitter=0.0 if deterministic_tie_break else TIE_JITTER,
        )


class FusedOutput(NamedTuple):
    root_visit_counts: torch.Tensor  # [B, A] int32
    root_value: torch.Tensor  # [B]
    root_predicted_value: torch.Tensor  # [B]
    max_tree_depth: torch.Tensor  # [B] int32


class FusedWeights(NamedTuple):
    """The FC networks the search runs, packed for the kernel.

    `flat` holds, layer after layer, W [in, out] row-major then b [out].
    Layer order: the dynamics MLP (its first layer over concat(h, one-hot)),
    then the reward, policy and value MLPs; `dims` gives each layer's
    (in, out) and `layer_counts` = (dynamics layers after the first, reward,
    policy, value layers).
    """

    flat: torch.Tensor  # [F] float32
    dims: Tuple[Tuple[int, int], ...]
    layer_counts: Tuple[int, int, int, int]


def extract_fc_weights(network, encoding_size):
    """Read an FCMuZero module into the JAX kernel's weight list.

    Returns (flat tuple of 2-D tensors, layer_counts) in the layout of the
    JAX package's extract_fc_weights:
      [W_dyn_h, W_dyn_a, b_dyn0, (W,b)*dyn_rest, (W,b)*reward,
       (W,b)*policy, (W,b)*value]
    with W as [in, out] and b as [1, out].
    """

    def mlp_layers(mlp):
        return [
            (layer.weight.detach().t(), layer.bias.detach().reshape(1, -1))
            for layer in mlp.dense_layers()
        ]

    dyn = mlp_layers(network.dynamics_state_network)
    w0, b0 = dyn[0]
    flat = [w0[:encoding_size], w0[encoding_size:], b0]
    counts = [len(dyn) - 1, 0, 0, 0]
    for w, b in dyn[1:]:
        flat += [w, b]
    for j, mlp in enumerate(
        (network.dynamics_reward_network, network.prediction_policy_network,
         network.prediction_value_network)
    ):
        layers = mlp_layers(mlp)
        counts[j + 1] = len(layers)
        for w, b in layers:
            flat += [w, b]
    return tuple(flat), tuple(counts)


def fused_weights(network, encoding_size) -> FusedWeights:
    """Pack an FCMuZero module's search networks into one f32 buffer."""
    weights_flat, layer_counts = extract_fc_weights(network, encoding_size)
    w_h, w_a, b0 = weights_flat[:3]
    rest = weights_flat[3:]
    layers = [(torch.cat([w_h, w_a], dim=0), b0)]
    layers += [(rest[i], rest[i + 1]) for i in range(0, len(rest), 2)]
    flat = torch.cat(
        [t.reshape(-1).to(torch.float32) for w, b in layers for t in (w, b)]
    ).contiguous()
    dims = tuple((int(w.shape[0]), int(w.shape[1])) for w, _ in layers)
    return FusedWeights(flat, dims, layer_counts)


def _unpack_layers(weights: FusedWeights):
    layers, off = [], 0
    for fan_in, fan_out in weights.dims:
        w = weights.flat[off:off + fan_in * fan_out].reshape(fan_in, fan_out)
        off += fan_in * fan_out
        b = weights.flat[off:off + fan_out]
        off += fan_out
        layers.append((w, b))
    return layers


def _elu(x):
    # expm1, as jax.nn.elu and the kernel's expm1f
    return torch.where(x > 0, x, torch.expm1(x))


# The plain version spells out the kernel's order of float32 operations:
# sums run sequentially over the reduced axis (with each product rounded
# before it is added, as the kernel, built with --fmad=false, does) and
# divisions by constants are true divisions (PyTorch on CUDA turns division
# by a Python scalar into multiplication by its reciprocal). On the card the
# two then round alike; an argmax between near-equal pUCT scores cannot flip.


def _sum_seq(terms):
    """Sequential float32 sum of a list of [B] tensors, from 0."""
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


def _matmul_seq(x, w):
    """x [B, in] @ w [in, out], summed over `in` in order."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=x.dtype, device=x.device)
    for i in range(w.shape[0]):
        acc = acc + x[:, i:i + 1] * w[i]
    return acc


def _dense(x, w, b):
    return _matmul_seq(x, w) + b


def _mulhilo32(m: int, x):
    """(high, low) 32-bit words of m * x, for a uint32 constant m and uint32
    values x held in int64: 16-bit limbs keep every product below 2^63."""
    p_lo = (x & 0xFFFF) * m
    mid = (x >> 16) * m + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(counter, key: int):
    """Philox4x32-10 (Salmon et al., SC'11), as csrc/mcts_fused.cu computes it.

    counter: four int64 tensors of uint32 words (broadcastable); key: the
    64-bit seed, low word first. Returns the four output words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def _jitter_bits(B, A, sim, levels, key, dev):
    """The kernel's tie-jitter bits [B, levels, A] (int64 in [0, 2^32)) of
    one simulation: action a at a level takes word a % 4 of the Philox
    block at counter (lane, simulation, level, a // 4)."""
    lane = torch.arange(B, dtype=torch.int64, device=dev)[:, None, None]
    level = torch.arange(levels, dtype=torch.int64, device=dev)[None, :, None]
    group = torch.arange((A + 3) // 4, dtype=torch.int64, device=dev)[None, None, :]
    words = philox4x32_10((lane, torch.tensor(sim, device=dev), level, group), key)
    return torch.stack(words, -1).reshape(B, levels, -1)[:, :, :A]


def _mlp(x, layers):
    for i, (w, b) in enumerate(layers):
        x = _dense(x, w, b)
        if i < len(layers) - 1:
            x = _elu(x)
    return x


def _softmax(logits):
    m = torch.amax(logits, dim=1, keepdim=True)
    e = torch.exp(logits - m)
    return e / _sum_seq(list(e.unbind(1)))[:, None]


def _decode(logits, support_size, two_eps):
    """support_to_scalar [B, S2] -> [B]: softmax, expectation, h^-1.
    two_eps: 2 * eps as a 0-d tensor on the device (a true division)."""
    p = _softmax(logits)
    x = _sum_seq([p[:, i] * float(i - support_size) for i in range(p.shape[1])])
    return torch.sign(x) * (
        torch.square(
            (torch.sqrt(1.0 + 4.0 * _EPS * (torch.abs(x) + 1.0 + _EPS)) - 1.0)
            / two_eps
        )
        - 1.0
    )


def search_plain(
    prior, hidden0, root_reward, to_play, legal, weights: FusedWeights, *,
    num_sims: int, num_players: int, pb_c_base: float, pb_c_init: float,
    discount: float, support_size: int, tie_jitter: float = 0.0, seed: int = 0,
):
    """Plain PyTorch version of the fused search kernel, B lanes at once.

    prior [B, A] f32 (masked, noised root prior), hidden0 [B, E] f32,
    root_reward [B] f32, to_play [B] i32, legal [B, A] (nonzero = legal).
    Returns (root visits [B, A] i32, root value [B] f32, max depth [B] i32).
    A tie_jitter > 0 adds the kernel's own jitter: the Philox4x32-10 stream
    keyed by `seed` (philox4x32_10, _jitter_bits).
    """
    dev = prior.device
    B, A = prior.shape
    E = hidden0.shape[1]
    N = num_sims + 1
    n_dyn_rest, n_rew, n_pol, _ = weights.layer_counts
    layers = _unpack_layers(weights)
    (w_dyn, b_dyn0), dyn_rest = layers[0], layers[1:1 + n_dyn_rest]
    w_dyn_h, w_dyn_a = w_dyn[:E], w_dyn[E:]
    off = 1 + n_dyn_rest
    rew_layers = layers[off:off + n_rew]
    pol_layers = layers[off + n_rew:off + n_rew + n_pol]
    val_layers = layers[off + n_rew + n_pol:]

    legal = legal != 0
    sign = 1.0 if num_players == 1 else -1.0
    ar = torch.arange(B, device=dev)
    iota_a = torch.arange(A, device=dev)
    # Constant divisors as 0-d device tensors: true divisions, as in the kernel.
    base_t = torch.tensor(pb_c_base, device=dev)
    two_eps = torch.tensor(2.0 * _EPS, device=dev)
    key = int(seed) & 0xFFFFFFFFFFFFFFFF  # as the wrapper passes it
    jitter_scale = tie_jitter / _U32_RANGE

    visit = torch.zeros((B, N), dtype=torch.int32, device=dev)
    vsum = torch.zeros((B, N), device=dev)
    reward = torch.zeros((B, N), device=dev)
    reward[:, 0] = root_reward
    tp = torch.zeros((B, N), dtype=torch.int32, device=dev)
    tp[:, 0] = to_play
    child_index = torch.full((B, N, A), -1, dtype=torch.long, device=dev)
    child_prior = torch.zeros((B, N, A), device=dev)
    child_prior[:, 0] = prior
    hidden = torch.zeros((B, N, E), device=dev)
    hidden[:, 0] = hidden0
    mn = torch.full((B,), float("inf"), device=dev)
    mx = torch.full((B,), float("-inf"), device=dev)
    maxd = torch.zeros((B,), dtype=torch.int32, device=dev)
    root_to_play = to_play.to(torch.int32)
    bnd = 0  # deepest leaf so far: a descent takes at most bnd + 1 selections

    for sim in range(num_sims):
        new_node = sim + 1
        span_ok = (mx > mn)[:, None]
        inv_span = (1.0 / torch.clamp(mx - mn, min=1e-30))[:, None]

        # ---- descend: follow max-pUCT edges to an unexpanded edge --------
        current = torch.zeros((B,), dtype=torch.long, device=dev)
        depth = torch.zeros((B,), dtype=torch.int32, device=dev)
        active = torch.ones((B,), dtype=torch.bool, device=dev)
        parent = torch.zeros_like(current)
        action = torch.zeros_like(current)
        path = torch.full((B, N), -1, dtype=torch.long, device=dev)
        path[:, 0] = 0
        levels = min(bnd + 1, N - 1)
        if tie_jitter > 0:
            bits = _jitter_bits(B, A, sim, levels, key, dev)
        for t in range(levels):
            idx = child_index[ar, current]  # [B, A]
            exists = idx >= 0
            idx_c = torch.clamp(idx, min=0)
            cvis = torch.where(exists, visit.gather(1, idx_c).to(torch.float32), 0.0)
            cvsum = torch.where(exists, vsum.gather(1, idx_c), 0.0)
            crew = torch.where(exists, reward.gather(1, idx_c), 0.0)
            cval = torch.where(cvis > 0, cvsum / torch.clamp(cvis, min=1.0), 0.0)
            pvis = visit[ar, current].to(torch.float32)[:, None]
            pb_c = (
                torch.log((pvis + pb_c_base + 1.0) / base_t) + pb_c_init
            ) * torch.sqrt(pvis) / (cvis + 1.0)
            prior_score = pb_c * child_prior[ar, current]
            q = crew + discount * sign * cval
            qn = torch.where(span_ok, (q - mn[:, None]) * inv_span, q)
            score = prior_score + torch.where(cvis > 0, qn, 0.0)
            score = torch.where((current == 0)[:, None] & ~legal,
                                float("-inf"), score)
            if tie_jitter > 0:
                score = score + bits[:, t].to(torch.float32) * jitter_scale
            m = torch.amax(score, dim=1, keepdim=True)
            sel = torch.amin(torch.where(score >= m, iota_a, A), dim=1)  # first max

            child = child_index[ar, current, sel]
            hits = active & (child < 0)
            parent = torch.where(hits, current, parent)
            action = torch.where(hits, sel, action)
            active = active & (child >= 0)
            current = torch.where(active, child, current)
            depth = depth + active.to(torch.int32)
            path[:, t + 1] = torch.where(active, current, path[:, t + 1])
        leaf_depth = depth + 1  # the new node sits one edge below

        # ---- recurrent inference -----------------------------------------
        h_par = hidden[ar, parent]  # [B, E]
        # split first layer: h @ W_h + onehot(action) @ W_a + b
        x = _matmul_seq(h_par, w_dyn_h) + w_dyn_a[action] + b_dyn0
        if n_dyn_rest > 0:
            x = _mlp(_elu(x), dyn_rest)
        raw_h = x  # UNNORMALIZED dynamics output
        hmin = torch.amin(raw_h, dim=1, keepdim=True)
        hmax = torch.amax(raw_h, dim=1, keepdim=True)
        scale = hmax - hmin
        scale = torch.where(scale < 1e-5, scale + 1e-5, scale)
        h_next = (raw_h - hmin) / scale

        leaf_reward = _decode(_mlp(raw_h, rew_layers), support_size, two_eps)
        leaf_prior = _softmax(_mlp(h_next, pol_layers))  # full action space
        leaf_value = _decode(_mlp(h_next, val_layers), support_size, two_eps)

        # ---- expand node `new_node` --------------------------------------
        reward[:, new_node] = leaf_reward
        if num_players == 1:
            vt_leaf = torch.zeros((B,), dtype=torch.int32, device=dev)
        else:
            vt_leaf = torch.bitwise_and(root_to_play + leaf_depth, 1)
        tp[:, new_node] = vt_leaf
        child_index[ar, parent, action] = new_node
        child_prior[:, new_node] = leaf_prior
        hidden[:, new_node] = h_next
        path[ar, leaf_depth.long()] = new_node

        # ---- backprop leaf -> root (reference self_play.py:406-430) ------
        bp_bound = int(leaf_depth.max())
        value = leaf_value
        for t_rev in range(bp_bound + 1):
            t = leaf_depth - t_rev
            valid = t >= 0
            node = path[ar, torch.clamp(t, min=0).long()]
            ntp = tp[ar, node]
            nrew = reward[ar, node]
            same = ntp == vt_leaf
            delta = value if num_players == 1 else torch.where(same, value, -value)
            vsum[ar, node] = vsum[ar, node] + torch.where(valid, delta, 0.0)
            visit[ar, node] = visit[ar, node] + valid.to(torch.int32)
            nvis = visit[ar, node].to(torch.float32)
            nval = torch.where(nvis > 0, vsum[ar, node] / torch.clamp(nvis, min=1.0), 0.0)
            stat = nrew + discount * sign * nval
            mn = torch.where(valid, torch.minimum(mn, stat), mn)
            mx = torch.where(valid, torch.maximum(mx, stat), mx)
            if num_players == 1:
                vnext = nrew + discount * value
            else:
                vnext = torch.where(same, -nrew, nrew) + discount * value
            value = torch.where(valid, vnext, value)
        maxd = torch.maximum(maxd, leaf_depth)
        bnd = max(bnd, bp_bound)

    # ---- root statistics out --------------------------------------------
    idx = child_index[:, 0]
    rv = visit.gather(1, torch.clamp(idx, min=0))
    visits = torch.where(idx >= 0, rv, 0).to(torch.int32)
    root_visit = visit[:, 0].to(torch.float32)
    root_value = torch.where(
        root_visit > 0, vsum[:, 0] / torch.clamp(root_visit, min=1.0), 0.0
    )
    return visits, root_value, maxd


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def search(
    prior, hidden0, root_reward, to_play, legal, weights: FusedWeights, *,
    num_sims: int, num_players: int, pb_c_base: float, pb_c_init: float,
    discount: float, support_size: int, tie_jitter: float = 0.0, seed: int = 0,
):
    """The fused search: the CUDA kernel for CUDA tensors, search_plain for
    CPU tensors. Same arguments and results as search_plain; on CUDA, legal
    must be int32. A tie_jitter > 0 draws from a Philox stream in the kernel
    keyed by `seed`."""
    device = prior.device
    if device.type == "cpu":
        return search_plain(
            prior, hidden0, root_reward, to_play, legal, weights,
            num_sims=num_sims, num_players=num_players, pb_c_base=pb_c_base,
            pb_c_init=pb_c_init, discount=discount, support_size=support_size,
            tie_jitter=tie_jitter, seed=seed,
        )
    if device.type != "cuda":
        raise ValueError(f"fused search runs on CUDA or CPU tensors, not {device}")
    B, A = prior.shape
    E = hidden0.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check("prior", prior, f32, (B, A), device)
    _check("hidden0", hidden0, f32, (B, E), device)
    _check("root_reward", root_reward, f32, (B,), device)
    _check("to_play", to_play, i32, (B,), device)
    _check("legal", legal, i32, (B, A), device)
    _check("weights.flat", weights.flat, f32, (weights.flat.numel(),), device)
    if num_players not in (1, 2):
        raise ValueError(f"num_players must be 1 or 2, got {num_players}")

    from muzero_general_tpu_torch.native import build

    lib = build.load_library("mcts_fused")
    visits = torch.empty((B, A), dtype=i32, device=device)
    value = torch.empty((B,), dtype=f32, device=device)
    depth = torch.empty((B,), dtype=i32, device=device)
    counts = (ctypes.c_int * 4)(*weights.layer_counts)
    dims = (ctypes.c_int * (2 * len(weights.dims)))(
        *[d for pair in weights.dims for d in pair]
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mcts_fused_search(
            prior.data_ptr(), hidden0.data_ptr(), root_reward.data_ptr(),
            to_play.data_ptr(), legal.data_ptr(), weights.flat.data_ptr(),
            visits.data_ptr(), value.data_ptr(), depth.data_ptr(),
            B, A, E, num_sims, num_players, support_size,
            pb_c_base, pb_c_init, discount, tie_jitter / _U32_RANGE,
            int(seed) & 0xFFFFFFFFFFFFFFFF,
            counts, dims, len(weights.dims), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"mcts_fused_search failed ({rc}): "
            f"{lib.mcts_fused_error_string(rc).decode()}"
        )
    search.launches += 1
    return visits, value, depth


search.launches = 0  # kernel launches, counted where the kernel is launched


def run_mcts_fused(
    network,
    observation,
    legal_mask,
    to_play,
    generator: Optional[torch.Generator],
    spec: FusedSpec,
    add_exploration_noise: bool = True,
    root_noise: Optional[torch.Tensor] = None,
    weights: Optional[FusedWeights] = None,
    seed: Optional[int] = None,
) -> FusedOutput:
    """Batched MCTS with the whole simulation loop in one kernel launch.

    Contract of the JAX run_mcts_fused: the root initial inference, legal
    mask and Dirichlet noise run in plain torch once per move (reference
    self_play.py:279-314, :467-476), the search in `search`. `root_noise`
    [B, A] injects the Gamma draws of the noise; `weights` takes the packed
    networks (default: packed from `network` now); `seed` keys the tie
    jitter (default: drawn from `generator`).
    """
    with torch.no_grad():
        root = prepare_root(
            network, observation, legal_mask, to_play, generator, spec,
            add_exploration_noise, root_noise,
        )
        if weights is None:
            weights = fused_weights(network, spec.encoding_size)
        if seed is None:
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                     device=root.prior.device))
        visits, value, depth = search(
            root.prior, root.hidden, root.reward, root.to_play, root.legal,
            weights, **search_kwargs(spec), seed=seed,
        )
    return FusedOutput(
        root_visit_counts=visits,
        root_value=value,
        root_predicted_value=root.predicted_value,
        max_tree_depth=depth,
    )


class RootInputs(NamedTuple):
    """The search's per-lane inputs, laid out as `search` takes them."""

    prior: torch.Tensor  # [B, A] f32 masked (and noised) root prior
    hidden: torch.Tensor  # [B, E] f32
    reward: torch.Tensor  # [B] f32
    to_play: torch.Tensor  # [B] i32
    legal: torch.Tensor  # [B, A] i32
    predicted_value: torch.Tensor  # [B] network value at the root


def prepare_root(network, observation, legal_mask, to_play, generator, spec,
                 add_exploration_noise=True, root_noise=None) -> RootInputs:
    """Root initial inference, legal masking and Dirichlet noise."""
    value_logits, reward_logits, policy_logits, hidden0 = network.initial_inference(
        observation
    )
    prior = mcts_ops.masked_softmax(policy_logits, legal_mask)
    if add_exploration_noise:
        prior = mcts_ops.add_root_noise(
            prior, legal_mask, spec.dirichlet_alpha, spec.exploration_fraction,
            generator, root_noise,
        )
    return RootInputs(
        prior=prior.to(torch.float32).contiguous(),
        hidden=hidden0.to(torch.float32).contiguous(),
        reward=support_to_scalar(reward_logits, spec.support_size).contiguous(),
        to_play=to_play.to(torch.int32).contiguous(),
        legal=legal_mask.to(torch.int32).contiguous(),
        predicted_value=support_to_scalar(value_logits, spec.support_size),
    )


def search_kwargs(spec: FusedSpec) -> dict:
    """FusedSpec -> the keyword arguments of search / search_plain."""
    return dict(
        num_sims=spec.num_simulations, num_players=spec.num_players,
        pb_c_base=spec.pb_c_base, pb_c_init=spec.pb_c_init,
        discount=spec.discount, support_size=spec.support_size,
        tie_jitter=spec.tie_jitter,
    )
