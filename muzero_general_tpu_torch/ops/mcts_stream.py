"""The streaming search for big-board trees (port of ops/mcts_stream.py).

For trees too big for the planar kernels (gomoku: 401 nodes x 121 actions
per lane) the JAX package keeps the tree as ONE packed slab per move,
edges[B, N + 1, S_PLANES, A_pad] f32 (planes: visit, vsum, reward, prior,
child index as f32; A padded to 128; row N a dummy row, see pack_tree), and
runs each simulation's descent and its backprop edge updates as one Pallas
kernel each (`_descend_stream_kernel`, `_update_edges_kernel`). Here they are
hand-written CUDA (csrc/mcts_stream.cu) behind the wrappers `descend_stream`
and `update_edges`; `descend_stream_plain` and `update_edges_plain` compute
the same functions in plain PyTorch with the kernels' float32 operations in
the kernels' order. The wrappers use the plain versions for CPU tensors only;
the tests and chip_smoke.py hold the kernels against them.

The slab layout, the depth-major [D, B] path arrays and `backprop_stream`'s
fold are the JAX package's, line for line, so pack_tree, the slab after each
simulation and the kernels' outputs compare element for element with the
JAX ones.

Tie jitter: the JAX kernel adds bits * tie_jitter / 2^32 from the TPU's
PRNG; the CUDA descent draws the bits from the port's Philox4x32-10 stream
keyed by `seed`, counter (lane, simulation, level, action // 4), as the
planar descent does, and descend_stream_plain computes the same stream
(ops/philox.py).
"""

import math

import torch

from muzero_general_tpu_torch.ops.mcts import associative_scan
from muzero_general_tpu_torch.ops.mcts_kernels import _check, _raise_on, _route
from muzero_general_tpu_torch.ops.philox import U32_RANGE, jitter_bits

# Packed-slab stat planes (the S axis).
P_VISIT, P_VSUM, P_REWARD, P_PRIOR, P_CHILD = 0, 1, 2, 3, 4
S_PLANES = 8  # padded plane count, as in the JAX package


def _pad128(x):
    return -(-x // 128) * 128


# ---------------------------------------------------------------------------
# The packed slab
# ---------------------------------------------------------------------------


def pack_tree(tree, A):
    """Node-major Tree ([B, N, A] slabs) -> packed edges [B, N + 1, S_PLANES,
    A_pad] f32 (JAX mcts_stream.py:532). Child indices ride as f32 (N < 2^24:
    exact); padding columns read as unexpanded (-1). Row N is a dummy row:
    masked path levels of the backprop aim their updates there, never at a
    live row. Once per move."""
    B, N, _ = tree.children_index.shape
    A_pad = _pad128(A)
    edges = torch.zeros((B, N + 1, S_PLANES, A_pad), dtype=torch.float32,
                        device=tree.children_index.device)
    edges[:, :N, P_VISIT, :A] = tree.children_visit.to(torch.float32)
    edges[:, :N, P_VSUM, :A] = tree.children_vsum
    edges[:, :N, P_REWARD, :A] = tree.children_reward
    edges[:, :N, P_PRIOR, :A] = tree.children_prior
    edges[:, :N, P_CHILD] = -1.0
    edges[:, :N, P_CHILD, :A] = tree.children_index.to(torch.float32)
    return edges


def unpack_tree(tree, edges, A):
    """Packed slab -> the Tree's slab fields (JAX mcts_stream.py:564), the
    dummy row dropped. Once per move."""
    N = tree.children_index.shape[1]
    return tree._replace(
        children_visit=edges[:, :N, P_VISIT, :A].to(torch.int32),
        children_vsum=edges[:, :N, P_VSUM, :A].contiguous(),
        children_reward=edges[:, :N, P_REWARD, :A].contiguous(),
        children_prior=edges[:, :N, P_PRIOR, :A].contiguous(),
        children_index=edges[:, :N, P_CHILD, :A].to(torch.int32),
    )


def expand_packed(edges, parent, action, new_node: int, leaf_reward, prior, A):
    """The expansion's writes, in place (JAX mcts_stream.py:577): edge
    (parent, action) of each lane gets the child index and the decoded
    reward, node new_node's row gets the prior."""
    b_idx = torch.arange(edges.shape[0], device=edges.device)
    parent, action = parent.long(), action.long()
    edges[b_idx, parent, P_CHILD, action] = float(new_node)
    edges[b_idx, parent, P_REWARD, action] = leaf_reward
    edges[:, new_node, P_PRIOR, :A] = prior
    return edges


# ---------------------------------------------------------------------------
# The descent: kernel 4
# ---------------------------------------------------------------------------


def descend_stream_plain(seed, sim, depth_bound, edges, root_legal, min_value, max_value,
                         *, num_players, pb_c_base, pb_c_init, discount, A, max_depth,
                         tie_jitter=0.0):
    """Plain PyTorch version of the stream descend kernel, all B lanes at once.

    edges: the packed slab [B, N + 1, S_PLANES, A_pad]; root_legal [B, A]
    (nonzero = legal); min/max_value [B]; depth_bound: a 0-d int tensor, the
    longest descent any lane can need (capped at max_depth). Returns (parent,
    action, leaf_depth [B] int32, path_n, path_a [D, B] int32, (reward,
    visit, vsum) [D, B] float32), D = max_depth + 1, depth-major as in the
    JAX package: path_n[t, b] is the node at depth t (-1 past the leaf's
    parent), path_a[t, b] the action taken from it (0 padded), the stats
    those of the selected edge as the descent read it (0 padded); leaf_depth
    is -1 for a lane still descending at the bound. A tie_jitter > 0 adds the
    kernel's Philox stream keyed by `seed` at simulation `sim`.
    """
    dev = edges.device
    B, N1 = edges.shape[:2]
    D = max_depth + 1
    bound = min(int(depth_bound), D - 1)
    disc_sign = discount * (1.0 if num_players == 1 else -1.0)
    # The pUCT numerator (log((pvis + base + 1) / base) + init) * sqrt(pvis)
    # depends only on the parent's visit count, an integer below N1: one
    # table per call, the same float32 operations as the kernel per entry
    # (base as a tensor: a true division, as in the kernel).
    p = torch.arange(N1 + 1, dtype=torch.float32, device=dev)[:, None]
    pb_c_num = (torch.log((p + pb_c_base + 1.0) / torch.tensor(pb_c_base, device=dev))
                + pb_c_init) * torch.sqrt(p)
    illegal = root_legal == 0
    span_ok = (max_value > min_value)[:, None]
    inv_span = (1.0 / torch.clamp(max_value - min_value, min=1e-30))[:, None]
    mn = min_value[:, None]
    b_idx = torch.arange(B, device=dev)
    if tie_jitter > 0 and bound > 0:
        bits = jitter_bits(B, A, sim, bound, int(seed) & 0xFFFFFFFFFFFFFFFF, dev)
        jitter = bits.to(torch.float32) * (tie_jitter / U32_RANGE)  # [B, bound, A]

    # One level per iteration for all lanes; what a level records is stacked
    # after the loop. Lanes are at the root at level 0 only (a child is never
    # the root), and a lane's values after it stopped are never recorded, so
    # the root's legal mask and +1 visit for an interior parent are level
    # constants.
    current = torch.zeros((B,), dtype=torch.long, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    was_active, sels, picks, nodes = [], [], [], []
    for t in range(bound):
        rows = edges[b_idx, current, :P_CHILD + 1, :A]  # [B, 5, A]
        cvis, cvsum, crew, cprior, _ = rows.unbind(1)
        visited = cvis > 0
        cval = torch.where(visited, cvsum / torch.clamp(cvis, min=1.0), 0.0)
        pvis = cvis.sum(1) + (1.0 if t > 0 else 0.0)
        pb_c = pb_c_num[pvis.long()] / (cvis + 1.0)
        q = crew + disc_sign * cval
        qn = torch.where(span_ok, (q - mn) * inv_span, q)
        score = pb_c * cprior + torch.where(visited, qn, 0.0)
        if t == 0:
            score = torch.where(illegal, -math.inf, score)
        if tie_jitter > 0:
            score = score + jitter[:, t]
        sel = torch.argmax(score, dim=1)  # the first max, as the kernel
        picked = rows.gather(2, sel.view(B, 1, 1).expand(B, P_CHILD + 1, 1))[..., 0]
        was_active.append(active)
        sels.append(sel)
        picks.append(picked)
        child = picked[:, P_CHILD].long()
        active = active & (child >= 0)
        current = torch.where(active, child, current)
        nodes.append(torch.where(active, current, -1))

    path_n = torch.full((D, B), -1, dtype=torch.int32, device=dev)
    path_n[0] = 0
    path_a = torch.zeros((D, B), dtype=torch.int32, device=dev)
    path_r, path_v, path_s = (torch.zeros((D, B), device=dev) for _ in range(3))
    depth = torch.zeros((B,), dtype=torch.long, device=dev)
    if bound > 0:
        on = torch.stack(was_active)  # [bound, B]: the lane descended at level t
        picked = torch.stack(picks)  # [bound, B, 5]
        path_a[:bound] = torch.where(on, torch.stack(sels), 0)
        path_r[:bound] = torch.where(on, picked[..., P_REWARD], 0.0)
        path_v[:bound] = torch.where(on, picked[..., P_VISIT], 0.0)
        path_s[:bound] = torch.where(on, picked[..., P_VSUM], 0.0)
        path_n[1:bound + 1] = torch.stack(nodes)
        depth = (path_n[1:] >= 0).sum(0)
    # A lane that reached an unexpanded edge did so from its deepest node.
    done = ~active
    parent = torch.where(done, path_n.gather(0, depth[None])[0], 0)
    action = torch.where(done, path_a.gather(0, depth[None])[0], 0)
    leaf_depth = torch.where(active, -1, depth + 1).to(torch.int32)
    return (parent.to(torch.int32), action.to(torch.int32), leaf_depth, path_n, path_a,
            (path_r, path_v, path_s))


def descend_stream(seed, sim, depth_bound, edges, root_legal, min_value, max_value, *,
                   num_players, pb_c_base, pb_c_init, discount, A, max_depth,
                   tie_jitter=0.0):
    """The stream descent: the CUDA kernel for CUDA tensors,
    descend_stream_plain for CPU tensors; same arguments and results. On
    CUDA, root_legal must be int32 and depth_bound an int32 0-d tensor on the
    card (read there, so the simulation loop never waits on the host), and
    the slab's rows 16-byte aligned (edges at a 16-byte address, A_pad a
    multiple of 4; pack_tree's slabs are), since the kernel reads them in
    float4s."""
    kwargs = dict(num_players=num_players, pb_c_base=pb_c_base, pb_c_init=pb_c_init,
                  discount=discount, A=A, max_depth=max_depth, tie_jitter=tie_jitter)
    device = edges.device
    if _route("descend_stream", device) == "cpu":
        return descend_stream_plain(seed, sim, depth_bound, edges, root_legal, min_value,
                                    max_value, **kwargs)
    if edges.dim() != 4 or edges.shape[2] != S_PLANES or not 0 < A <= edges.shape[3]:
        raise ValueError(f"edges must be [B, N + 1, {S_PLANES}, A_pad >= A={A}], "
                         f"got {tuple(edges.shape)}")
    B, N1, _, A_pad = edges.shape
    D = max_depth + 1
    f32, i32 = torch.float32, torch.int32
    _check("depth_bound", depth_bound, i32, (), device)
    _check("edges", edges, f32, (B, N1, S_PLANES, A_pad), device)
    _check("root_legal", root_legal, i32, (B, A), device)
    _check("min_value", min_value, f32, (B,), device)
    _check("max_value", max_value, f32, (B,), device)
    if num_players not in (1, 2):
        raise ValueError(f"num_players must be 1 or 2, got {num_players}")
    if edges.data_ptr() % 16 or A_pad % 4:
        raise ValueError("edges' rows must be 16-byte aligned (a 16-byte address and A_pad "
                         f"a multiple of 4), got address {edges.data_ptr():#x}, A_pad {A_pad}")

    from muzero_general_tpu_torch.native import build

    lib = build.load_library("mcts_stream")
    parent, action, leaf_depth = (torch.empty((B,), dtype=i32, device=device)
                                  for _ in range(3))
    path_n, path_a = (torch.empty((D, B), dtype=i32, device=device) for _ in range(2))
    path_r, path_v, path_s = (torch.empty((D, B), dtype=f32, device=device)
                              for _ in range(3))
    disc_sign = discount * (1.0 if num_players == 1 else -1.0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mcts_stream_descend(
            depth_bound.data_ptr(), edges.data_ptr(), root_legal.data_ptr(),
            min_value.data_ptr(), max_value.data_ptr(), parent.data_ptr(),
            action.data_ptr(), leaf_depth.data_ptr(), path_n.data_ptr(), path_a.data_ptr(),
            path_r.data_ptr(), path_v.data_ptr(), path_s.data_ptr(),
            B, N1, A, A_pad, D, int(sim), pb_c_base, pb_c_init, disc_sign,
            tie_jitter / U32_RANGE, int(seed) & 0xFFFFFFFFFFFFFFFF, stream,
        )
    _raise_on(rc, lib.mcts_stream_error_string, "mcts_stream_descend")
    descend_stream.launches += 1
    return parent, action, leaf_depth, path_n, path_a, (path_r, path_v, path_s)


descend_stream.launches = 0  # kernel launches, counted where the kernel is launched


# ---------------------------------------------------------------------------
# The backprop's edge updates: kernel 5
# ---------------------------------------------------------------------------


def update_edges_plain(edges, path_n, path_a, delta, mask, bound):
    """Plain PyTorch version of the update kernel, in place on `edges`.

    For every lane b and level t < bound with mask[t, b] != 0:
    edges[b, path_n[t, b], P_VISIT, path_a[t, b]] += mask[t, b] and the
    P_VSUM entry += delta[t, b]. path_n, path_a, delta, mask: [D, B]; bound:
    an int or a 0-d int tensor. The live targets of one call are distinct (a
    descent never repeats an edge), so the order of the updates does not
    matter. Returns edges."""
    D = path_n.shape[0]
    t_idx = torch.arange(D, device=path_n.device)[:, None]
    tt, bb = ((t_idx < bound) & (mask != 0)).nonzero(as_tuple=True)
    n, a = path_n[tt, bb].long(), path_a[tt, bb].long()
    edges[bb, n, P_VISIT, a] = edges[bb, n, P_VISIT, a] + mask[tt, bb]
    edges[bb, n, P_VSUM, a] = edges[bb, n, P_VSUM, a] + delta[tt, bb]
    return edges


def update_edges(edges, path_n, path_a, delta, mask, bound):
    """The edge updates: the CUDA kernel for CUDA tensors,
    update_edges_plain for CPU tensors; same arguments, same in-place update.
    On CUDA, bound must be an int32 0-d tensor on the card."""
    device = edges.device
    if _route("update_edges", device) == "cpu":
        return update_edges_plain(edges, path_n, path_a, delta, mask, bound)
    if edges.dim() != 4 or edges.shape[2] != S_PLANES:
        raise ValueError(f"edges must be [B, N + 1, {S_PLANES}, A_pad], "
                         f"got {tuple(edges.shape)}")
    B, N1, _, A_pad = edges.shape
    D = path_n.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check("bound", bound, i32, (), device)
    _check("edges", edges, f32, (B, N1, S_PLANES, A_pad), device)
    for name, t, dtype in (("path_n", path_n, i32), ("path_a", path_a, i32),
                           ("delta", delta, f32), ("mask", mask, f32)):
        _check(name, t, dtype, (D, B), device)

    from muzero_general_tpu_torch.native import build

    lib = build.load_library("mcts_stream")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mcts_stream_update(
            bound.data_ptr(), edges.data_ptr(), path_n.data_ptr(), path_a.data_ptr(),
            delta.data_ptr(), mask.data_ptr(), B, N1, A_pad, D, stream,
        )
    _raise_on(rc, lib.mcts_stream_error_string, "mcts_stream_update")
    update_edges.launches += 1
    return edges


update_edges.launches = 0  # kernel launches, counted where the kernel is launched


# ---------------------------------------------------------------------------
# The backprop fold
# ---------------------------------------------------------------------------


def backprop_stream(tree, edges, path_n, path_a, leaf_depth, leaf_value, path_stats, spec,
                    *, use_update_kernel=True, plain_kernels=False):
    """Depth-major backprop of one leaf per lane on the packed slab (JAX
    mcts_stream.py:433, line for line): the values propagated to each depth
    come from one reverse associative scan over the [D, B] path, the edge
    updates from `update_edges` (or, with use_update_kernel=False, two
    scatter-adds), min/max from the captured pre-update stats.

    path_stats: (reward, visit, vsum) [D, B], the leaf edge's reward already
    patched in. Updates `edges` and the tree's root_visit, root_vsum,
    min_value and max_value in place; returns (tree, edges). plain_kernels:
    the update runs as update_edges_plain (the card comparisons).
    """
    D, B = path_n.shape
    dev = path_n.device
    t_idx = torch.arange(D, device=dev)[:, None]
    L = leaf_depth.long()[None, :]
    sign = 1.0 if spec.num_players == 1 else -1.0

    edge_mask = t_idx < L
    # Masked levels aim at the dummy row (index N, see pack_tree), never at
    # a live row; they add zero there.
    pn = torch.where(edge_mask, path_n, edges.shape[1] - 1)
    pa = torch.where(edge_mask, path_a, 0)
    r_edge = torch.where(edge_mask, path_stats[0], 0.0)
    ev_old = torch.where(edge_mask, path_stats[1], 0.0)
    es_old = torch.where(edge_mask, path_stats[2], 0.0)

    if spec.num_players == 1:
        same = torch.ones((D, B), dtype=torch.bool, device=dev)
        s_next = torch.ones((D, B), device=dev)
    else:
        same = ((L - t_idx) % 2) == 0
        s_next = torch.where(((L - (t_idx + 1)) % 2) == 0, -1.0, 1.0)

    a_coef = torch.where(edge_mask, spec.discount, 0.0)
    b_coef = torch.where(edge_mask, s_next * r_edge,
                         torch.where(t_idx == L, leaf_value[None, :], 0.0))

    def compose(acc, elem):
        a_l, b_l = acc
        a_r, b_r = elem
        return a_r * a_l, a_r * b_l + b_r

    _, v = associative_scan(compose, (a_coef, b_coef), reverse=True, dim=0)
    node_mask = t_idx <= L
    delta = torch.where(same, v, -v)

    # Min/max over the post-update node stats, from the pre-update reads.
    def node_shift(edge_arr, root_row):
        return torch.cat([root_row[None, :], edge_arr[:-1]], dim=0)

    nvis = node_shift(ev_old, tree.root_visit.to(torch.float32)) + 1.0
    nsum = node_shift(es_old, tree.root_vsum)
    nrew = node_shift(r_edge, tree.root_reward)
    node_val = (nsum + delta) / torch.clamp(nvis, min=1.0)
    stat = nrew + spec.discount * sign * node_val
    big = torch.finfo(torch.float32).max
    stat_min = torch.amin(torch.where(node_mask, stat, big), dim=0)
    stat_max = torch.amax(torch.where(node_mask, stat, -big), dim=0)

    edge_delta = torch.cat([delta[1:], torch.zeros((1, B), device=dev)], dim=0)
    edge_delta = torch.where(edge_mask, edge_delta, 0.0)
    visit_add = edge_mask.to(torch.float32)
    if use_update_kernel:
        update = update_edges_plain if plain_kernels else update_edges
        update(edges, pn, pa, edge_delta, visit_add, torch.amax(leaf_depth))
    else:
        brow = torch.arange(B, device=dev)[None, :].expand(D, B)
        index = (brow, pn.long(), torch.full_like(brow, P_VSUM), pa.long())
        edges.index_put_(index, edge_delta, accumulate=True)
        index = index[:2] + (torch.full_like(brow, P_VISIT), index[3])
        edges.index_put_(index, visit_add, accumulate=True)
    tree.root_visit.add_(1)
    tree.root_vsum.add_(delta[0])
    torch.minimum(tree.min_value, stat_min, out=tree.min_value)
    torch.maximum(tree.max_value, stat_max, out=tree.max_value)
    return tree, edges
