"""Host cost of one call of the staged search's tree-kernel wrappers.

Times `ops.mcts_kernels.descend_planar` and `ops.mcts_kernels.backprop` of
the port found under --root, called back to back from Python at connect4's
K = 1 shapes (256 lanes, 7 actions, 201 nodes, 201 path slots), beside a
bare ctypes call of the same kernel with its arguments made in advance: the
wrapper's own cost is the difference. The tree is a fresh root, so every
descent ends at depth 1 and a launch's device work is a few microseconds:
the loop is bound by the host, and its time per call is the host's. Each
number is the median over --blocks blocks of --calls calls, the four loops
interleaved block by block. Prints the card's name and power limit, then
one JSON line.

    python3 wrapper_cost.py [--root DIR] [--blocks 20] [--calls 500]

To compare two checkouts, run it once per checkout in one chip call, in the
order parent, change, change, parent. It times any checkout whose
descend_planar and backprop take the arguments below.
"""

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time


def host_us(fn, calls, torch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parent),
                    help="checkout whose muzero_general_tpu_torch is timed")
    ap.add_argument("--blocks", type=int, default=20)
    ap.add_argument("--calls", type=int, default=500)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("wrapper_cost: no CUDA device")
    from muzero_general_tpu_torch.native import build
    from muzero_general_tpu_torch.ops import mcts_kernels

    if not pathlib.Path(mcts_kernels.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"wrapper_cost: imported {mcts_kernels.__file__}, not from {root}")

    dev = torch.device("cuda")
    B, A, N = 256, 7, 201
    D = N  # max_depth + 1, max_depth = num_simulations
    f32, i32 = torch.float32, torch.int32
    index = torch.full((B, A, N), -1, dtype=i32, device=dev)
    prior = torch.full((B, A, N), 1.0 / A, dtype=f32, device=dev)
    visit = torch.zeros((B, A, N), dtype=i32, device=dev)
    vsum = torch.zeros((B, A, N), dtype=f32, device=dev)
    reward = torch.zeros((B, A, N), dtype=f32, device=dev)
    legal = torch.ones((B, A), dtype=i32, device=dev)
    mn = torch.zeros((B,), dtype=f32, device=dev)
    mx = torch.zeros((B,), dtype=f32, device=dev)
    rvis = torch.ones((B,), dtype=i32, device=dev)
    rvsum = torch.zeros((B,), dtype=f32, device=dev)
    rrew = torch.zeros((B,), dtype=f32, device=dev)
    leaf_value = torch.zeros((B,), dtype=f32, device=dev)
    bound = torch.ones((), dtype=i32, device=dev)
    seed, sim = 12345, 100
    pb_c_base, pb_c_init, discount, jitter = 19652.0, 1.25, 1.0, 1e-5
    dargs = (seed, sim, bound, index, prior, visit, vsum, reward, legal, mn, mx)
    dkw = dict(num_players=2, pb_c_base=pb_c_base, pb_c_init=pb_c_init, discount=discount,
               max_depth=D - 1, tie_jitter=jitter)
    _, _, leaf_depth, path_n, path_a = mcts_kernels.descend_planar(*dargs, **dkw)
    bargs = (path_n, path_a, leaf_depth, leaf_value, visit, vsum, reward, rvis, rvsum, rrew,
             mn, mx)
    bkw = dict(num_players=2, discount=discount, planar=True)

    # The bare calls: the C interface of this checkout, its ints counted
    # from the ctypes declaration (a mode flag may follow the ints below).
    lib = build.load_library("mcts_kernels")
    api = build._KERNELS["mcts_kernels"]["api"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = [torch.empty((B,), dtype=i32, device=dev) for _ in range(3)]
    out += [torch.empty((B, D), dtype=i32, device=dev) for _ in range(2)]
    d_ints = (B, A, N, D, sim, 0)[:api["mcts_descend_planar"][1].count(ctypes.c_int)]
    d_raw = (bound, index, prior, visit, vsum, reward, legal, mn, mx, *out)
    d_raw = (*(t.data_ptr() for t in d_raw), *d_ints, pb_c_base, pb_c_init, -discount,
             jitter / 4.2949673e9, seed, stream)  # philox.U32_RANGE
    b_ints = (B, D, A * N, 1, N, 2, 0)[:api["mcts_backprop"][1].count(ctypes.c_int)]
    b_raw = (*(t.data_ptr() for t in bargs), *b_ints, discount, -discount, stream)

    loops = {
        "descend_planar": lambda: mcts_kernels.descend_planar(*dargs, **dkw),
        "descend_planar_bare": lambda: lib.mcts_descend_planar(*d_raw),
        "backprop": lambda: mcts_kernels.backprop(*bargs, **bkw),
        "backprop_bare": lambda: lib.mcts_backprop(*b_raw),
    }
    if lib.mcts_descend_planar(*d_raw) or lib.mcts_backprop(*b_raw):
        raise SystemExit("wrapper_cost: a bare kernel call failed")
    with torch.no_grad():
        for fn in loops.values():
            for _ in range(50):  # warm-up
                fn()
        samples = {name: [] for name in loops}
        for _ in range(args.blocks):
            for name, fn in loops.items():
                samples[name].append(host_us(fn, args.calls, torch))
    med = {name: statistics.median(v) for name, v in samples.items()}
    result = {
        "root": str(root),
        "us_per_call": med,
        "us_per_call_min": {name: min(v) for name, v in samples.items()},
        "wrapper_us": {k: med[k] - med[k + "_bare"] for k in ("descend_planar", "backprop")},
        "blocks": args.blocks,
        "calls": args.calls,
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
