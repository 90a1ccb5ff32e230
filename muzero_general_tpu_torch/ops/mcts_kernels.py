"""The staged search's tree kernels: the descent and the backprop.

Port of muzero_general_tpu/ops/mcts_pallas.py (`descend_planar`, `descend`
and `backprop`). The JAX package runs the descent of all B trees and the
leaf-to-root fold as one Pallas kernel each per simulation
(`_descend_kernel_planar`, `_descend_kernel`, `_backprop_kernel`); here they
are hand-written CUDA (csrc/mcts_kernels.cu) behind the wrappers
`descend_planar` (planar [B, A, N] slabs, optionally marking the visits it
takes, for multi-leaf rounds), `descend` (node-major [B, N, A] slabs) and
`backprop` (either layout, optionally pre-marked). `descend_planar_plain`,
`descend_plain` and `backprop_plain` compute the same functions in plain
PyTorch with the kernels' float32 operations in the kernels' order: the
wrappers use them for CPU tensors only, and the tests and chip_smoke.py hold
the kernels against them.

Each plain version follows its kernel, not ops/mcts.py's plain-op route:
the descent normalizes values by multiplying with 1 / max(max - min, 1e-30)
(mcts_pallas.py:274, :321), where the plain-op route divides, and the
backprop folds leaf to root sequentially (mcts_pallas.py:437-490), where
the plain-op route runs an associative scan.

Routing: `fits_vmem_planar`/`choose_block_planar` and
`fits_vmem_backprop`/`choose_block_backprop` are copies of the JAX
package's predicates (mcts_pallas.py:643-709), so SearchSpec.from_config
takes the kernel route for exactly the configurations where the JAX package
does; gomoku-class trees fall outside it and take the stream kernels
(ops/mcts_stream.py). The JAX package's MUZERO_PALLAS_VMEM_BUDGET override
tunes a TPU's VMEM and means nothing on the card, so the budget here is the
JAX default, fixed.

Tie jitter: the JAX kernels add bits * tie_jitter / 2^32 from the TPU's
PRNG; the CUDA descent draws the bits from a Philox4x32-10 stream keyed by
`seed`, counter (lane, simulation, level, action // 4), and the plain
descents compute the same stream (ops/philox.py). A multi-leaf round's k-th
selection of round r passes simulation r * K + k, so its K selections draw
different streams.
"""

import torch

from muzero_general_tpu_torch.ops.philox import U32_RANGE, jitter_bits

# The JAX package's default VMEM budget for the lane block (mcts_pallas.py:531)
VMEM_BUDGET = 12 * 1024 * 1024


def _pad128(x):
    return -(-x // 128) * 128


def _pad8(x):
    return -(-x // 8) * 8


def fits_vmem_planar(B, N, A, budget_bytes=VMEM_BUDGET):
    """The JAX package's VMEM check for the planar descend kernel
    (mcts_pallas.py:643-665)."""
    slab = _pad8(A) * _pad128(N)
    per = B * 4 * slab * 8  # 5 resident + ~3 temporaries
    small = 4 * _pad8(B) * (2 * _pad128(A) + 4 * _pad128(N + 1) + 8 * _pad128(1))
    return per + small < budget_bytes


def fits_vmem_backprop(B, N, A, budget_bytes=VMEM_BUDGET):
    """The JAX package's VMEM check for the backprop kernel
    (mcts_pallas.py:680-697)."""
    per = B * 4 * (5 * _pad128(N * A) + 2 * _pad128(N + 1) + 8 * _pad128(1))
    return per + 4 * _pad8(B) * _pad128(N + 1) < budget_bytes


def _choose_block(fits, B, N, A):
    block = B
    while block >= 8:
        if fits(block, N, A):
            return block
        if block % 2:
            return None
        block //= 2
    return None


def choose_block_planar(B, N, A):
    """Largest divisor block of B whose planar working set fits the JAX
    package's VMEM budget; None if none (mcts_pallas.py:668-677)."""
    return _choose_block(fits_vmem_planar, B, N, A)


def choose_block_backprop(B, N, A):
    """As choose_block_planar, for the backprop kernel
    (mcts_pallas.py:700-709)."""
    return _choose_block(fits_vmem_backprop, B, N, A)


def _descend_plain(seed, sim, depth_bound, children_index, children_prior, children_visit,
                   children_vsum, children_reward, root_legal, min_value, max_value, *,
                   planar, mark_visits, num_players, pb_c_base, pb_c_init, discount,
                   max_depth, tie_jitter):
    """The descend kernel's plain version in either layout (see
    descend_planar_plain)."""
    dev = children_index.device
    if planar:
        B, A, _ = children_index.shape
    else:
        B, _, A = children_index.shape
    D = max_depth + 1
    bound = min(int(depth_bound), D - 1)
    disc_sign = discount * (1.0 if num_players == 1 else -1.0)
    base_t = torch.tensor(pb_c_base, device=dev)  # a true division, as in the kernel
    legal = root_legal != 0
    span_ok = (max_value > min_value)[:, None]
    inv_span = (1.0 / torch.clamp(max_value - min_value, min=1e-30))[:, None]
    mn = min_value[:, None]
    iota_a = torch.arange(A, device=dev)
    b_idx = torch.arange(B, device=dev)
    if tie_jitter > 0 and bound > 0:
        bits = jitter_bits(B, A, sim, bound, int(seed) & 0xFFFFFFFFFFFFFFFF, dev)
        jitter_scale = tie_jitter / U32_RANGE

    current = torch.zeros((B,), dtype=torch.long, device=dev)
    depth = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    parent = torch.zeros_like(current)
    action = torch.zeros_like(current)
    path_n = torch.full((B, D), -1, dtype=torch.int32, device=dev)
    path_n[:, 0] = 0
    path_a = torch.zeros((B, D), dtype=torch.int32, device=dev)
    for t in range(bound):
        if planar:
            node = current[:, None, None].expand(B, A, 1)

            def take(slab):
                return slab.gather(2, node)[..., 0]  # the node's A edges, [B, A]
        else:
            node = current[:, None, None].expand(B, 1, A)

            def take(slab):
                return slab.gather(1, node)[:, 0]

        cvis = take(children_visit).to(torch.float32)
        cval = torch.where(cvis > 0, take(children_vsum) / torch.clamp(cvis, min=1.0), 0.0)
        pvis = cvis.sum(1, keepdim=True) + (current != 0).to(torch.float32)[:, None]
        pb_c = (
            torch.log((pvis + pb_c_base + 1.0) / base_t) + pb_c_init
        ) * torch.sqrt(pvis) / (cvis + 1.0)
        prior_score = pb_c * take(children_prior)
        q = take(children_reward) + disc_sign * cval
        qn = torch.where(span_ok, (q - mn) * inv_span, q)
        score = prior_score + torch.where(cvis > 0, qn, 0.0)
        score = torch.where((current == 0)[:, None] & ~legal, float("-inf"), score)
        if tie_jitter > 0:
            score = score + bits[:, t].to(torch.float32) * jitter_scale
        m = torch.amax(score, dim=1, keepdim=True)
        sel = torch.amin(torch.where(score >= m, iota_a, A), dim=1)  # first max

        path_a[:, t] = torch.where(active, sel, path_a[:, t])
        if mark_visits:
            # +1 on the edge each still-active lane takes, after the scores
            # (one entry per lane: no two adds meet).
            children_visit.index_put_((b_idx, sel, current), active.to(torch.int32),
                                      accumulate=True)
        child = take(children_index).gather(1, sel[:, None])[:, 0].long()
        hits = active & (child < 0)
        parent = torch.where(hits, current, parent)
        action = torch.where(hits, sel, action)
        active = active & (child >= 0)
        current = torch.where(active, child, current)
        depth = depth + active.to(torch.int32)
        path_n[:, t + 1] = torch.where(active, current, path_n[:, t + 1]).to(torch.int32)
    leaf_depth = torch.where(active, -1, depth + 1).to(torch.int32)
    return parent.to(torch.int32), action.to(torch.int32), leaf_depth, path_n, path_a


def descend_planar_plain(seed, sim, depth_bound, children_index, children_prior,
                         children_visit, children_vsum, children_reward, root_legal,
                         min_value, max_value, *, num_players, pb_c_base, pb_c_init,
                         discount, max_depth, tie_jitter=0.0, mark_visits=False):
    """Plain PyTorch version of the planar descend kernel, all B lanes at
    once.

    children_*: planar [B, A, N] slabs (index and visit int32, the rest
    float32); root_legal [B, A] (nonzero = legal); min/max_value [B];
    depth_bound: a 0-d int tensor, the longest descent any lane can need
    (capped at max_depth). Returns (parent, action, leaf_depth [B],
    path_nodes, path_actions [B, max_depth + 1]), int32: path_nodes[b, t] is
    the node at depth t (-1 past the leaf's parent), path_actions[b, t] the
    action taken from it (0 padded), and leaf_depth the new leaf's depth, -1
    for a lane still descending after the bound. A tie_jitter > 0 adds the
    kernel's Philox stream keyed by `seed` at simulation `sim`.

    mark_visits (multi-leaf rounds): +1 on the visit of every edge a lane
    takes, the final unexpanded one included, IN PLACE on children_visit,
    each after its level's scores (the JAX kernel aliases that slab to its
    sixth output, mcts_pallas.py:759-762; here the caller's tensor is the
    result). The root's own visit counter is the caller's.
    """
    return _descend_plain(
        seed, sim, depth_bound, children_index, children_prior, children_visit,
        children_vsum, children_reward, root_legal, min_value, max_value, planar=True,
        mark_visits=mark_visits, num_players=num_players, pb_c_base=pb_c_base,
        pb_c_init=pb_c_init, discount=discount, max_depth=max_depth, tie_jitter=tie_jitter)


def descend_plain(seed, sim, depth_bound, children_index, children_prior, children_visit,
                  children_vsum, children_reward, root_legal, min_value, max_value, *,
                  num_players, pb_c_base, pb_c_init, discount, max_depth, tie_jitter=0.0):
    """Plain PyTorch version of the node-major descend kernel: as
    descend_planar_plain on node-major [B, N, A] slabs, without the mark
    (the JAX kernel has none, mcts_pallas.py:577)."""
    return _descend_plain(
        seed, sim, depth_bound, children_index, children_prior, children_visit,
        children_vsum, children_reward, root_legal, min_value, max_value, planar=False,
        mark_visits=False, num_players=num_players, pb_c_base=pb_c_base,
        pb_c_init=pb_c_init, discount=discount, max_depth=max_depth, tie_jitter=tie_jitter)


def _strides(planar, shape):
    """(stride_n, stride_a) of edge (node, action) in a lane's flat slab:
    planar [B, A, N] or node-major [B, N, A]."""
    return (1, shape[2]) if planar else (shape[2], 1)


def backprop_plain(path_nodes, path_actions, leaf_depth, leaf_value, children_visit,
                   children_vsum, children_reward, root_visit, root_vsum, root_reward,
                   min_value, max_value, *, num_players, discount, planar=True,
                   pre_marked=False):
    """Plain PyTorch version of the backprop kernel, all B lanes at once.

    Folds each lane's leaf_value [B] from its leaf (depth leaf_depth, -1 for
    none) to the root along path_nodes/path_actions [B, D], IN PLACE on
    children_visit (int32) and children_vsum (planar [B, A, N] or node-major
    [B, N, A]), root_visit, root_vsum, min_value and max_value [B]; reads
    children_reward (the leaf edge's reward written by the expansion) and
    root_reward. Returns the six updated tensors.

    pre_marked (multi-leaf rounds): the path's visits and the root's were
    already counted by the marking descent, so no visit is added and a node
    value divides its value sum by max(visit, 1) instead of visit + 1
    (mcts_pallas.py:469-477).
    """
    B = path_nodes.shape[0]
    stride_n, stride_a = _strides(planar, children_visit.shape)
    visit = children_visit.view(B, -1)
    vsum = children_vsum.view(B, -1)
    reward = children_reward.reshape(B, -1)
    disc_sign = discount * (1.0 if num_players == 1 else -1.0)
    value = leaf_value.clone()
    mn, mx = min_value.clone(), max_value.clone()
    rvis, rvsum = root_visit.clone(), root_vsum.clone()
    L = leaf_depth.long()
    for t_rev in range(int(L.max()) + 1 if B else 0):
        t = L - t_rev
        valid = t >= 0
        at_root = valid & (t == 0)
        on_edge = valid & (t >= 1)
        sgn = 1.0 if num_players == 1 or t_rev % 2 == 0 else -1.0
        delta = value * sgn
        prev = torch.clamp(t - 1, min=0)[:, None]
        e = (path_nodes.long().gather(1, prev) * stride_n
             + path_actions.long().gather(1, prev) * stride_a)  # [B, 1]
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
        nval = torch.where(
            at_root,
            rvsum / torch.clamp(rvis, min=1).to(torch.float32),
            es_new / denom,
        )
        nrew = torch.where(at_root, root_reward, reward.gather(1, e)[:, 0])
        stat = nrew + disc_sign * nval
        mn = torch.where(valid, torch.minimum(mn, stat), mn)
        mx = torch.where(valid, torch.maximum(mx, stat), mx)
        if num_players == 1:
            vnext = nrew + discount * value
        else:
            vnext = -sgn * nrew + discount * value
        value = torch.where(valid, vnext, value)
    root_visit.copy_(rvis)
    root_vsum.copy_(rvsum)
    min_value.copy_(mn)
    max_value.copy_(mx)
    return children_visit, children_vsum, root_visit, root_vsum, min_value, max_value


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a tensor on {device}, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _route(name, device):
    """"cpu" for the plain version, "cuda" for the kernel; raises otherwise."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {device}")
    return device.type


def _raise_on(rc, error_string, fn):
    """Raise if a kernel library's C function `fn` returned a CUDA error;
    error_string: that library's code -> message function."""
    if rc != 0:
        raise RuntimeError(f"{fn} failed ({rc}): {error_string(rc).decode()}")


def _descend(fn_name, plain, wrapper, seed, sim, depth_bound, children_index, children_prior,
             children_visit, children_vsum, children_reward, root_legal, min_value, max_value,
             *, planar, mark_visits, num_players, pb_c_base, pb_c_init, discount, max_depth,
             tie_jitter):
    """Launch one of the two descend kernels, counted on `wrapper` (or run
    `plain` on the CPU)."""
    device = children_index.device
    if _route(fn_name, device) == "cpu":
        kwargs = dict(mark_visits=True) if mark_visits else {}
        return plain(seed, sim, depth_bound, children_index, children_prior, children_visit,
                     children_vsum, children_reward, root_legal, min_value, max_value,
                     num_players=num_players, pb_c_base=pb_c_base, pb_c_init=pb_c_init,
                     discount=discount, max_depth=max_depth, tie_jitter=tie_jitter, **kwargs)
    if planar:
        B, A, N = children_index.shape
    else:
        B, N, A = children_index.shape
    slab = tuple(children_index.shape)
    D = max_depth + 1
    f32, i32 = torch.float32, torch.int32
    _check("depth_bound", depth_bound, i32, (), device)
    _check("children_index", children_index, i32, slab, device)
    _check("children_prior", children_prior, f32, slab, device)
    _check("children_visit", children_visit, i32, slab, device)
    _check("children_vsum", children_vsum, f32, slab, device)
    _check("children_reward", children_reward, f32, slab, device)
    _check("root_legal", root_legal, i32, (B, A), device)
    _check("min_value", min_value, f32, (B,), device)
    _check("max_value", max_value, f32, (B,), device)
    if num_players not in (1, 2):
        raise ValueError(f"num_players must be 1 or 2, got {num_players}")

    from muzero_general_tpu_torch.native import build

    lib = build.load_library("mcts_kernels")
    parent = torch.empty((B,), dtype=i32, device=device)
    action = torch.empty((B,), dtype=i32, device=device)
    leaf_depth = torch.empty((B,), dtype=i32, device=device)
    path_n = torch.empty((B, D), dtype=i32, device=device)
    path_a = torch.empty((B, D), dtype=i32, device=device)
    disc_sign = discount * (1.0 if num_players == 1 else -1.0)
    ints = (B, A, N, D, int(sim)) + ((int(mark_visits),) if planar else ())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(
            depth_bound.data_ptr(), children_index.data_ptr(), children_prior.data_ptr(),
            children_visit.data_ptr(), children_vsum.data_ptr(),
            children_reward.data_ptr(), root_legal.data_ptr(), min_value.data_ptr(),
            max_value.data_ptr(), parent.data_ptr(), action.data_ptr(),
            leaf_depth.data_ptr(), path_n.data_ptr(), path_a.data_ptr(),
            *ints, pb_c_base, pb_c_init, disc_sign,
            tie_jitter / U32_RANGE, int(seed) & 0xFFFFFFFFFFFFFFFF, stream,
        )
    _raise_on(rc, lib.mcts_kernels_error_string, fn_name)
    wrapper.launches += 1
    if mark_visits:
        wrapper.marked_launches += 1
    return parent, action, leaf_depth, path_n, path_a


def descend_planar(seed, sim, depth_bound, children_index, children_prior,
                   children_visit, children_vsum, children_reward, root_legal,
                   min_value, max_value, *, num_players, pb_c_base, pb_c_init,
                   discount, max_depth, tie_jitter=0.0, mark_visits=False):
    """The planar descent: the CUDA kernel for CUDA tensors,
    descend_planar_plain for CPU tensors; same arguments and results (with
    mark_visits, the visits are marked in place on children_visit). On CUDA, root_legal must be int32 and
    depth_bound an int32 0-d tensor on the card (read there, so the
    simulation loop never waits on the host)."""
    return _descend("mcts_descend_planar", descend_planar_plain, descend_planar, seed, sim,
                    depth_bound, children_index, children_prior, children_visit,
                    children_vsum, children_reward, root_legal, min_value, max_value,
                    planar=True, mark_visits=mark_visits, num_players=num_players,
                    pb_c_base=pb_c_base, pb_c_init=pb_c_init, discount=discount,
                    max_depth=max_depth, tie_jitter=tie_jitter)


# Kernel launches, counted where the kernel is launched: all, and those in
# the marking mode.
descend_planar.launches = 0
descend_planar.marked_launches = 0


def descend(seed, sim, depth_bound, children_index, children_prior, children_visit,
            children_vsum, children_reward, root_legal, min_value, max_value, *,
            num_players, pb_c_base, pb_c_init, discount, max_depth, tie_jitter=0.0):
    """The node-major descent (counterpart of mcts_pallas.descend): the CUDA
    kernel for CUDA tensors, descend_plain for CPU tensors; as
    descend_planar on [B, N, A] slabs, without the mark. On the same tree,
    seed and simulation it gives descend_planar's outputs bit for bit."""
    return _descend("mcts_descend", descend_plain, descend, seed, sim, depth_bound,
                    children_index, children_prior, children_visit, children_vsum,
                    children_reward, root_legal, min_value, max_value, planar=False,
                    mark_visits=False, num_players=num_players, pb_c_base=pb_c_base,
                    pb_c_init=pb_c_init, discount=discount, max_depth=max_depth,
                    tie_jitter=tie_jitter)


descend.launches = 0  # kernel launches, counted where the kernel is launched


def backprop(path_nodes, path_actions, leaf_depth, leaf_value, children_visit,
             children_vsum, children_reward, root_visit, root_vsum, root_reward,
             min_value, max_value, *, num_players, discount, planar=True,
             pre_marked=False):
    """The backprop: the CUDA kernel for CUDA tensors, backprop_plain for
    CPU tensors; same arguments, same in-place updates and results."""
    kwargs = dict(num_players=num_players, discount=discount, planar=planar,
                  pre_marked=pre_marked)
    args = (path_nodes, path_actions, leaf_depth, leaf_value, children_visit,
            children_vsum, children_reward, root_visit, root_vsum, root_reward,
            min_value, max_value)
    device = children_visit.device
    if _route("backprop", device) == "cpu":
        return backprop_plain(*args, **kwargs)
    B, D = path_nodes.shape
    slab = tuple(children_visit.shape)
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
        ("path_nodes", path_nodes, i32, (B, D)), ("path_actions", path_actions, i32, (B, D)),
        ("leaf_depth", leaf_depth, i32, (B,)), ("leaf_value", leaf_value, f32, (B,)),
        ("children_visit", children_visit, i32, slab),
        ("children_vsum", children_vsum, f32, slab),
        ("children_reward", children_reward, f32, slab),
        ("root_visit", root_visit, i32, (B,)), ("root_vsum", root_vsum, f32, (B,)),
        ("root_reward", root_reward, f32, (B,)), ("min_value", min_value, f32, (B,)),
        ("max_value", max_value, f32, (B,)),
    ):
        _check(name, t, dtype, shape, device)
    if len(slab) != 3 or slab[0] != B:
        raise ValueError(f"the edge slabs must be [B, ., .], got {slab}")
    if num_players not in (1, 2):
        raise ValueError(f"num_players must be 1 or 2, got {num_players}")
    stride_n, stride_a = _strides(planar, slab)

    from muzero_general_tpu_torch.native import build

    lib = build.load_library("mcts_kernels")
    disc_sign = discount * (1.0 if num_players == 1 else -1.0)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.mcts_backprop(
            *(t.data_ptr() for t in args), B, D, slab[1] * slab[2], stride_n, stride_a,
            num_players, int(pre_marked), discount, disc_sign, stream,
        )
    _raise_on(rc, lib.mcts_kernels_error_string, "mcts_backprop")
    backprop.launches += 1
    backprop.pre_marked_launches += int(pre_marked)
    return children_visit, children_vsum, root_visit, root_vsum, min_value, max_value


# Kernel launches, counted where the kernel is launched: all, and those in
# the pre-marked mode.
backprop.launches = 0
backprop.pre_marked_launches = 0
