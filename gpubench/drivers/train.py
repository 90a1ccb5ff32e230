"""Training traffic: the port's `Learner.train_steps` on batches made on the
card from the seed, at the configuration's batch and unroll.

Set-up builds the learner, loads weights made from the seed
(reference/resnet.py `make_params`, one draw on the card), and makes
`fused_train_steps` (M) batches, batch m from its own generator
(`fill_batch`): observations uniform in [0, 1), actions uniform, policy
targets a softmax of normal draws (they sum to 1), value targets normal
times `value_scale`, reward targets `reward_value` with probability
`reward_rate` (both well inside the support), PER weights in [0.5, 1) and a
gradient scale of the unroll length. The first call is the window's own:
train_steps on all M batches from step 0, read as the optimizer updates
(`checked_call`): each step's loss, the first gradient as the optimizer
took it (its momentum buffer after step 1, the gradient plus the weight
decay term) and each parameter's change after step 3. `warmup_calls` more
calls follow. The window then repeats train_steps on the M batches until
`seconds` have passed; the rate is batch x steps over the time from the
window's start to the end of the last call. A call whose last loss is not
finite counts its M steps as failed.

Every call after the checked steps starts from step 0: the weights,
batch-norm statistics and momentum are put back (three multi-tensor
copies, inside the window's time). The published SGD (lr 0.05, momentum
0.9) diverges from a seeded start within 5-7 steps on any batches tried
(the loss NaN by step 7), in the reference too, so a window of free-running
steps would time NaN arithmetic; each call's M steps from the start stay
finite.

After the window, with the peak memory read and the learner freed, the
reference (reference/train.py) makes the same weights and batches 0-2 and
takes the same three SGD steps in float32, and the readings are compared
leaf by leaf.

The traced run first profiles two calls (the card's operations only; the
first takes the profiler's start-up costs and is not measured) with host
spans around each step, the loss's forward and the optimizer's update
(the backward and the rest of a step lie in `step`), then times its
window's calls.
"""

import torch

from gpubench.drivers import (device_summary, now, peak_bytes, port_config, profiled, release,
                              sync)
from gpubench.reference import train as ref_train
from gpubench.reference.resnet import make_params, stacked_channels
from gpubench.spans import Spans
from gpubench.yardstick import trace as trace_lib

CHECKED_STEPS = 3
_GOLDEN = 0x9E3779B97F4A7C15


def batch_seed(seed, m):
    return (seed + (m + 1) * _GOLDEN) % 2**63


def empty_batches(cfgd, M, device):
    B, U, A = cfgd["batch_size"], cfgd["num_unroll_steps"], len(cfgd["action_space"])
    _, h, w = cfgd["observation_shape"]
    return {
        "observation": torch.empty((M, B, stacked_channels(cfgd), h, w), device=device),
        "action": torch.empty((M, B, U + 1), dtype=torch.int32, device=device),
        "target_value": torch.empty((M, B, U + 1), device=device),
        "target_reward": torch.empty((M, B, U + 1), device=device),
        "target_policy": torch.empty((M, B, U + 1, A), device=device),
        "weight": torch.empty((M, B), device=device),
        "gradient_scale": torch.empty((M, B, U + 1), device=device),
    }


def fill_batch(batch, traffic, cfgd, seed, m):
    """Batch m of the seed, written in place into `batch` ({key: [B, ...]})."""
    g = torch.Generator(device=batch["observation"].device).manual_seed(batch_seed(seed, m))
    obs = batch["observation"].uniform_(0.0, 1.0, generator=g)
    obs.copy_((obs < traffic["pixel_density"]).float())
    batch["action"].random_(0, len(cfgd["action_space"]), generator=g)
    batch["target_value"].normal_(generator=g).mul_(traffic["value_scale"])
    reward = batch["target_reward"].uniform_(0.0, 1.0, generator=g)
    reward.copy_((reward < traffic["reward_rate"]).float() * traffic["reward_value"])
    policy = batch["target_policy"].normal_(generator=g)
    policy.copy_(torch.softmax(policy * traffic["policy_sharpness"], dim=-1))
    batch["weight"].uniform_(0.5, 1.0, generator=g)
    batch["gradient_scale"].fill_(cfgd["num_unroll_steps"])


def one_batch(cfgd, traffic, seed, m, device):
    batch = {k: v[0] for k, v in empty_batches(cfgd, 1, device).items()}
    fill_batch(batch, traffic, cfgd, seed, m)
    return batch


def _load_params(learner, params):
    state = learner.network.state_dict()
    for name in state:
        if name.endswith("num_batches_tracked"):
            params[name] = torch.zeros_like(state[name])
    learner.network.load_state_dict(params, strict=True)


def run(cell, seed, seconds, trace, device, t_start, control=None):
    from muzero_general_tpu_torch import trainer

    traffic, cfgd = cell.traffic, cell.config["config"]
    cfg = port_config(cell, seed)
    learner = trainer.Learner(cfg, device, seed=seed)
    _load_params(learner, make_params(cfgd, seed, device))
    M, B = cfg.fused_train_steps, cfg.batch_size
    if M < CHECKED_STEPS:
        raise ValueError(f"fused_train_steps must be at least {CHECKED_STEPS} (the checked steps)")
    batches = empty_batches(cfgd, M, device)
    for m in range(M):
        fill_batch({k: v[m] for k, v in batches.items()}, traffic, cfgd, seed, m)

    state = list(learner.network.state_dict().values())
    initial = [t.clone() for t in state]
    # The checked steps: the window's own call, from step 0 on all M batches.
    losses, first, change = checked_call(learner, batches)
    momentum = [b for b in (learner.optimizer.state[p].get("momentum_buffer")
                            for p in learner.network.parameters()) if b is not None]

    def from_the_start():
        """The weights, batch-norm statistics and momentum of step 0."""
        torch._foreach_copy_(state, initial)
        if momentum:
            torch._foreach_zero_(momentum)

    for _ in range(traffic["warmup_calls"]):
        from_the_start()
        learner.train_steps(batches)
    sync(device)
    setup_s = now() - t_start

    calls, prof, failed = [], None, 0
    if trace:  # the profiled call, then the window's calls
        spans = Spans()
        spans.wrap(trainer, "loss_fn", "forward")
        spans.wrap(learner, "_step", "step")
        spans.wrap(learner.optimizer, "step", "optimizer")
        try:
            prof, wall_s = profiled(
                lambda: (from_the_start(), learner.train_steps(batches)), device, spans,
                "train_steps")
        finally:
            spans.restore()
        calls.append({"wall_s": wall_s, "steps": M, "profiled": True})
    t0 = now()
    while True:
        ts = now()
        from_the_start()
        metrics, _ = learner.train_steps(batches)
        last = float(metrics["total_loss"])
        te = now()
        failed += 0 if last == last and abs(last) != float("inf") else M
        calls.append({"wall_s": te - ts, "steps": M, "profiled": False})
        if te - t0 >= seconds:
            break
    steps = M * sum(not c["profiled"] for c in calls)
    rate = B * steps / (te - t0)
    memory = peak_bytes(device)
    tr = trace_lib.parse(prof, spans.intervals) if trace else None
    del prof
    readings = {"trace": tr, "calls": calls, "batch": B, "config": cfgd,
                "device_type": torch.device(device).type}
    del learner, batches, metrics, state, initial, momentum
    release(device)

    ref = reference_readings(cfgd, traffic, seed, device)
    extra, breakdown, note = device_summary(readings, "train_steps")
    out = {"setup_s": setup_s, "end_to_end": {"train_samples_per_s": rate},
           "readings": readings, "attempted": steps, "failed": failed,
           "numbers": compare((losses, first, change), ref),
           "memory_peak_bytes": memory, "device": extra, "breakdown": breakdown, "note": note}
    if control:
        # The reference in a lower precision, and with half of each batch
        # left out, each in the program's place.
        ctl = reference_readings(cfgd, traffic, seed, device, precision=control)
        half = reference_readings(cfgd, traffic, seed, device, rows=B // 2)
        out["control_numbers"] = compare((ctl[0], ctl[1], ctl[3]), ref)
        out["fault_numbers"] = {"half_batch": compare((half[0], half[1], half[3]), ref)}
    return out


def checked_call(learner, batches):
    """The window's call, train_steps on all M batches from step 0, read as
    the optimizer updates: each step's loss (each new metrics dict the
    learner holds, at an update or after the call), the first gradient as
    the optimizer took it (its momentum buffer after the first update: the
    gradient plus the weight decay term) and each parameter's change after
    the CHECKED_STEPS-th. Returns (losses, {leaf: first norm}, {leaf: change
    norm}), the last two None where the optimizer never updated that far."""
    named = dict(learner.network.named_parameters())
    params = list(named.values())
    start = [p.detach().clone() for p in params]
    seen, taken = [learner.metrics], {}

    def new_metrics():
        if all(learner.metrics is not m for m in seen):
            seen.append(learner.metrics)

    def after_update(optimizer, args, kwargs):
        new_metrics()
        taken["updates"] = taken.get("updates", 0) + 1
        if taken["updates"] == 1:
            bufs = [optimizer.state[p].get("momentum_buffer") for p in params]
            taken["first"] = [torch.zeros(()) if b is None else b.norm() for b in bufs]
        if taken["updates"] == CHECKED_STEPS:
            taken["change"] = torch._foreach_norm(
                torch._foreach_sub([p.detach() for p in params], start))

    handle = learner.optimizer.register_step_post_hook(after_update)
    try:
        learner.train_steps(batches)
    finally:
        handle.remove()
    new_metrics()
    losses = [float(m["total_loss"]) for m in seen[1:CHECKED_STEPS + 1]]
    first, change = (None if key not in taken else
                     {n: float(v) for n, v in zip(named, taken[key])}
                     for key in ("first", "change"))
    return losses, first, change


def reference_readings(cfgd, traffic, seed, device, precision="float32", rows=None):
    """The reference's three steps from the seed's weights and batches 0-2:
    (losses, {leaf: first gradient norm as the optimizer takes it},
    {leaf: bare first gradient norm}, {leaf: change norm}). rows: keep only
    the first `rows` rows of each batch (a planted fault)."""
    params = make_params(cfgd, seed, device)
    batches = []
    for m in range(CHECKED_STEPS):
        batch = one_batch(cfgd, traffic, seed, m, device)
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
        batches.append(batch)
    losses, first, bare, change = ref_train.sgd_steps(cfgd, params, batches, precision)
    norms = [{n: float(t.norm()) for n, t in d.items()} for d in (first, bare, change)]
    return (losses, *norms)


def compare(prog, ref):
    """The compared numbers of the program's readings against the
    reference's: the relative gap of each step's loss and the widest of
    them, and of the first gradient and the change the median, the
    90th percentile and the widest gap over the leaves. Each gap of a leaf
    is measured against the reference's norm of that leaf or of the median
    leaf, whichever is larger; the change leaves out leaves whose bare
    reference gradient is under a thousandth of the median leaf's (they move
    by rounding alone). A reading the program did not give is left out, and
    so fails its limit."""
    p_losses, p_first, p_change = prog
    r_losses, r_first, r_bare, r_change = ref
    out = {}
    if len(p_losses) == len(r_losses):
        loss = [abs(a - b) / abs(b) for a, b in zip(p_losses, r_losses)]
        out.update({f"loss{k}_gap": gap for k, gap in enumerate(loss, 1)}, loss_gap=max(loss))

    def quantile(values, q):
        values = sorted(values)
        return values[min(len(values) - 1, int(q * len(values)))]

    def gaps(got, want, names):
        floor = quantile([want[n] for n in names], 0.5)
        return [abs(got[n] - want[n]) / max(want[n], floor) for n in names]

    names = sorted(r_first)
    bare_floor = 1e-3 * quantile([r_bare[n] for n in names], 0.5)
    moving = [n for n in names if r_bare[n] >= bare_floor]
    for key, got, want, leaves in (("grad_gap", p_first, r_first, names),
                                   ("update_gap", p_change, r_change, moving)):
        if got is not None:
            g = gaps(got, want, leaves)
            out.update({key: quantile(g, 0.5), f"{key}_p90": quantile(g, 0.9),
                        f"{key}_worst": max(g)})
    return out

