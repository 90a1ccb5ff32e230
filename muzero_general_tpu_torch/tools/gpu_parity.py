"""On-card parity check: the search kernels against the plain-op search
(port of tools/tpu_parity.py).

The oracle is the staged search on the plain-op route (ops/mcts.py: the
descent and backprop in PyTorch ops, no kernel) on the card, float32 with
TF32 off, first-index ties. Against it, on the same network, inputs and
injected root noise:

1. cartpole (the FC net, seeded weights; 64 lanes, 50 simulations, lane 1's
   action 0 illegal), deterministic ties:
   - the fused search (kernel 1, csrc/mcts_fused.cu) and
   - the staged search on the kernel route (the planar descent and backprop,
     kernels 2 and 3, csrc/mcts_kernels.cu):
   0 mismatched root visit counts (the kernels are bit-equal to their plain
   versions, so JAX's 1% allowance for the fused kernel's ELU is not
   needed); root values within JAX's bounds: the fused search 1e-3 + 1e-4
   relative (its leaf values pass through its own float32 support decode),
   the staged one 1e-5 (+ 1e-5 relative);
2. the jittered fused search (the production tie jitter), held on its
   invariants: visits sum to the simulation count, the illegal action
   unvisited, root values within JAX's loose bound (mean 0.1, max 0.6);
3. gomoku (the 6 x 128 ResNet, seeded weights; 16 lanes, 48 simulations,
   lane 2's first five actions illegal), deterministic ties, the stream
   route (kernels 4 and 5, csrc/mcts_stream.cu): 0 mismatched visit counts,
   root values within 1e-4 (+ 1e-5 relative; JAX's bound).

Information only, as JAX's `net_precision` tiers: the deterministic fused
and staged runs again with TF32 on (cuBLAS's float32 products in TF32; the
networks' convolutions keep it off, models/common.py FullPrecision),
against the same oracle.

Usage (on the card):
    python -m muzero_general_tpu_torch.tools.gpu_parity

Prints the card's name and power limit, JAX's `OK` / `FAIL` line, the
information lines, then one JSON line per kernel and route: its case, the
share of mismatched visit counts, the largest root-value gap, its launches
and whether it passed. Exits 0 when every check passes, else 1. Without a
card (or with `--device cpu`) it refuses with exit 1, as JAX's tool does
on a CPU backend.
"""

import argparse
import json
import sys

import numpy as np
import torch

from muzero_general_tpu_torch.tools import profiling

# The deterministic cases' root-value bounds (atol, rtol): JAX's np.allclose
# calls (tools/tpu_parity.py:89-91, :101-102, :193-194; rtol 1e-5 by default)
FUSED_TOL, STAGED_TOL, STREAM_TOL = (1e-3, 1e-4), (1e-5, 1e-5), (1e-4, 1e-5)
JITTER_MEAN, JITTER_MAX = 0.1, 0.6  # JAX's loose bound on the jittered run's values


def compare(ref, got, tol):
    """The share of root visit counts that differ, and the largest root
    value gap, of `got` against the oracle `ref` (search outputs); and the
    failures: any visit mismatch, a gap beyond tol = (atol, rtol) of the
    oracle's value."""
    v_ref, v_got = ref.root_visit_counts.cpu(), got.root_visit_counts.cpu()
    mismatch = float((v_ref != v_got).double().mean())
    value = ref.root_value.cpu()
    gap = (value - got.root_value.cpu()).abs()
    failures = []
    if mismatch > 0.0:
        failures.append(f"visit mismatch frac={mismatch:.4f}")
    if not bool((gap <= tol[0] + tol[1] * value.abs()).all()):
        failures.append(f"root values diverge (max gap {float(gap.max()):.3g}, bound {tol})")
    return mismatch, float(gap.max()), failures


class _TF32:
    """cuBLAS's float32 products in TF32 (on) or full float32 (off) inside
    the block; restores the setting after."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev


def cartpole_case(device):
    from muzero_general_tpu_torch.games.cartpole import MuZeroConfig
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.ops import mcts as M

    cfg = MuZeroConfig()
    cfg.num_simulations = 50
    B = 64
    net = MuZeroNetwork(cfg, device, seed=0)
    obs = torch.from_numpy(
        np.random.default_rng(5).normal(size=(B, 1, 1, 4)).astype(np.float32)).to(device)
    legal = torch.ones((B, 2), dtype=torch.bool, device=device)
    legal[1, 0] = False
    to_play = torch.zeros((B,), dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    noise = M.sample_gamma(cfg.root_dirichlet_alpha, (B, 2), gen, device)
    return cfg, net, obs, legal, to_play, noise


def gomoku_case(device):
    from muzero_general_tpu_torch.games.gomoku import MuZeroConfig
    from muzero_general_tpu_torch.models import MuZeroNetwork
    from muzero_general_tpu_torch.ops import mcts as M

    cfg = MuZeroConfig()
    cfg.num_simulations = 48
    B = 16
    net = MuZeroNetwork(cfg, device, seed=1)
    obs = torch.from_numpy(np.random.default_rng(6).normal(
        size=(B,) + profiling.stacked_shape(cfg)).astype(np.float32)).to(device)
    A = len(cfg.action_space)
    legal = torch.ones((B, A), dtype=torch.bool, device=device)
    legal[2, :5] = False
    to_play = torch.zeros((B,), dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    noise = M.sample_gamma(cfg.root_dirichlet_alpha, (B, A), gen, device)
    return cfg, net, obs, legal, to_play, noise


def staged(cfg, net, obs, legal, to_play, noise, device, route, deterministic=True):
    """run_mcts on `route`: "plain-op", "planar" (the kernel route) or
    "stream"; with the noise injected and tie-jitter seed 777."""
    from muzero_general_tpu_torch.ops import mcts as M

    spec = M.SearchSpec.from_config(cfg, batch_size=obs.shape[0], device=device)._replace(
        deterministic_tie_break=deterministic, use_kernels=route == "planar",
        use_stream=route == "stream")
    with torch.no_grad():
        return M.run_mcts(net.initial_inference, net.recurrent_inference, obs, legal, to_play,
                          None, spec, add_exploration_noise=True, root_noise=noise, seed=777)


def fused(cfg, net, obs, legal, to_play, noise, deterministic=True):
    from muzero_general_tpu_torch.ops import mcts_fused as F

    spec = F.FusedSpec.from_config(cfg, deterministic_tie_break=deterministic)
    return F.run_mcts_fused(net, obs, legal, to_play, None, spec, add_exploration_noise=True,
                            root_noise=noise, seed=777)


def checks(device):
    """Every case on `device`. Returns (failures, summary numbers, the JSON
    records, the information lines)."""
    failures, records, info = [], [], []

    def record(kernels, route, case, mismatch, gap, launches, fails):
        failures.extend(f"{case} {route}: {f}" for f in fails)
        for kernel in kernels:
            records.append({"kernel": kernel, "route": route, "case": case,
                            "visit_mismatch": mismatch, "max_root_value_gap": gap,
                            "launches": launches.get(kernel, 0), "ok": not fails})

    with _TF32(False):
        c = cartpole_case(device)
        ref = staged(*c, device, "plain-op")
        # ---- 1. deterministic fused and staged kernel routes -----------
        before = profiling.launch_counts()
        got = fused(*c)
        mismatch_f, gap_f, fails = compare(ref, got, FUSED_TOL)
        record(["mcts_fused_search"], "fused", "deterministic", mismatch_f, gap_f,
               profiling.launches_since(before), fails)
        before = profiling.launch_counts()
        got = staged(*c, device, "planar")
        mismatch_p, gap_p, fails = compare(ref, got, STAGED_TOL)
        record(["descend_planar", "backprop"], "staged", "deterministic", mismatch_p, gap_p,
               profiling.launches_since(before), fails)

        # ---- 2. the jittered fused run: invariants, loose values --------
        cfg, legal = c[0], c[3]
        before = profiling.launch_counts()
        got_j = fused(*c, deterministic=False)
        launches = profiling.launches_since(before)
        vj = got_j.root_visit_counts.cpu()
        dv = (got_j.root_value - ref.root_value).abs().cpu()
        fails = []
        if not bool((vj.sum(-1) == cfg.num_simulations).all()):
            fails.append("jittered visits do not sum to num_simulations")
        if bool(vj[~legal.cpu()].any()):
            fails.append("masked root action got visits (jittered)")
        if float(dv.mean()) > JITTER_MEAN or float(dv.max()) > JITTER_MAX:
            fails.append(f"jittered root values too far from oracle (mean {float(dv.mean()):.3f},"
                         f" max {float(dv.max()):.3f})")
        exact = float((vj == ref.root_visit_counts.cpu()).double().mean())
        record(["mcts_fused_search"], "fused", "jittered", 1.0 - exact, float(dv.max()),
               launches, fails)

        # ---- 3. gomoku: the stream route --------------------------------
        g = gomoku_case(device)
        gref = staged(*g, device, "plain-op")
        before = profiling.launch_counts()
        gstr = staged(*g, device, "stream")
        mismatch_s, gap_s, fails = compare(gref, gstr, STREAM_TOL)
        record(["descend_stream", "update_edges"], "stream", "deterministic", mismatch_s,
               gap_s, profiling.launches_since(before), fails)

    # ---- 4. information only: TF32 off and on ---------------------------
    for tf32 in (False, True):
        with _TF32(tf32):
            for route, search, tol in (("fused", lambda: fused(*c), FUSED_TOL),
                                       ("staged", lambda: staged(*c, device, "planar"),
                                        STAGED_TOL)):
                out = search()
                mm, dm, _ = compare(ref, out, tol)
                dvt = (out.root_value - ref.root_value).abs()
                info.append(f"tf32={'on' if tf32 else 'off'} {route}: visit mismatch {mm:.1%}, "
                            f"root value gap mean {float(dvt.mean()):.4f} max {dm:.4f}")
    summary = {"fused": mismatch_f, "staged": mismatch_p, "stream": mismatch_s,
               "jitter_exact": exact, "jitter_gap_mean": float(dv.mean())}
    return failures, summary, records, info


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default); cpu is refused")
    return ap.parse_args(argv)


def main(argv=None, print_fn=print):
    args = parse_args(argv)
    device = torch.device("cuda" if args.device is None else args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        print("gpu_parity: needs a CUDA card", file=sys.stderr)
        return 1
    print_fn(profiling.card_line(device))
    failures, s, records, info = checks(device)
    if failures:
        print_fn("gpu_parity FAIL: " + "; ".join(failures))
    else:
        print_fn(f"gpu_parity OK: deterministic fused {1 - s['fused']:.1%} exact / staged "
                 f"{1 - s['staged']:.1%} exact / stream {1 - s['stream']:.1%} exact vs f32 "
                 f"oracle; jittered run {s['jitter_exact']:.1%} exact (ties resolve randomly, "
                 f"by design), value gap mean {s['jitter_gap_mean']:.4f}")
    for line in info:
        print_fn(f"gpu_parity info: {line} (informational: divergence expected with TF32)")
    for rec in records:
        print_fn(json.dumps(rec))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
