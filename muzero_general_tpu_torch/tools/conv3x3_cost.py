"""Device time of the fused 3x3 conv (ops/conv3x3.py, csrc/conv3x3.cu) beside
the library's, at the folded ResNet games' shapes.

For each shape, y = relu(conv3x3(x, w) + b [+ skip]) three ways, each the
median of --graphs CUDA graphs of --iters calls, timed by CUDA events:
`kernel_ms`, the hand-written kernel; `library_ms`, what the folded twin
ran before it (F.conv2d with the bias, the skip add, ReLU: cuDNN's default
choice of algorithm, float32 without TF32); `library_best_ms`, the same
under `cudnn.benchmark` (cuDNN's fastest non-TF32 algorithm, chosen at the
warm-up). `bound_ms` is the shape's FLOPs at 67 TFLOP/s (float32, the FMAs
on the CUDA cores), `roofline` bound_ms / kernel_ms; `floor_ms` the kernel
at one sample. Each line also gives the largest error of the kernel and of
cuDNN against a float64 conv of the same inputs, relative to the largest
output. A shape the kernel has no launch plan for (Cout not a multiple of
its 32-channel tile) gives the library's numbers and null for the
kernel's. Prints the card's name and power limit, then one JSON line a
shape.

    python -m muzero_general_tpu_torch.tools.conv3x3_cost [--iters 20] [--graphs 5] \\
        [--only connect4]

No benchmark cell runs it; ops/conv3x3.py KERNEL_SHAPES keeps the shapes
and batches where it found the kernel faster than cuDNN.
"""

import argparse
import json
import statistics
import sys

import torch
import torch.nn.functional as F

from muzero_general_tpu_torch.models.common import FullPrecision
from muzero_general_tpu_torch.ops import conv3x3 as op
from muzero_general_tpu_torch.tools import profiling

PEAK_F32 = 67e12  # FLOP/s, H100 SXM, FMAs on the CUDA cores

# (game, N, Cin, Cout, H, W): the search's batches (lanes x leaves a round)
# at each folded ResNet game's 3x3 convs: the tower's, the dynamics conv's
# (the action plane as one more channel) and the representation's first.
SHAPES = [
    ("connect4", 256, 64, 64, 6, 7), ("connect4", 512, 64, 64, 6, 7),
    ("connect4", 1024, 64, 64, 6, 7), ("connect4", 1024, 65, 64, 6, 7),
    ("connect4", 1024, 3, 64, 6, 7), ("connect4", 2048, 64, 64, 6, 7),
    ("connect4", 2048, 65, 64, 6, 7), ("connect4", 64, 3, 64, 6, 7),
    ("connect4", 256, 3, 64, 6, 7),
    ("gomoku", 64, 128, 128, 11, 11), ("gomoku", 64, 129, 128, 11, 11),
    ("gomoku", 64, 3, 128, 11, 11), ("gomoku", 512, 128, 128, 11, 11),
    ("tictactoe", 64, 16, 16, 3, 3), ("tictactoe", 64, 17, 16, 3, 3),
    ("tictactoe", 64, 3, 16, 3, 3),
    ("twentyone", 64, 32, 32, 3, 3), ("twentyone", 64, 33, 32, 3, 3),
    ("twentyone", 64, 3, 32, 3, 3), ("twentyone", 1024, 32, 32, 3, 3),
    ("breakout", 8, 8, 8, 48, 48), ("breakout", 8, 16, 16, 24, 24),
    ("breakout", 8, 16, 16, 12, 12), ("breakout", 8, 16, 16, 6, 6),
    ("breakout", 8, 17, 16, 6, 6),
]


def inputs(n, cin, cout, h, w, dev, seed=0):
    """x, w, b, skip drawn from a seeded generator (weights at the conv's
    U(+-1/sqrt(fan_in)) init)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bound = (9 * cin) ** -0.5
    x = torch.rand((n, cin, h, w), generator=gen, device=dev)
    wt = (torch.rand((cout, cin, 3, 3), generator=gen, device=dev) * 2 - 1) * bound
    b = (torch.rand((cout,), generator=gen, device=dev) * 2 - 1) * bound
    skip = torch.rand((n, cout, h, w), generator=gen, device=dev)
    return x, wt, b, skip


def library(x, wt, b, skip):
    y = F.conv2d(x, wt, b, 1, 1)
    return F.relu(y if skip is None else y + skip)


def graph_ms(fn, iters, graphs):
    """Median over `graphs` CUDA graphs of `iters` calls of fn: ms a call."""
    fn()  # warm-up (and cuDNN's choice under benchmark), outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(graphs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def relative_error(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def measure(n, cin, cout, h, w, skip_add, iters, graphs, dev):
    x, wt, b, skip = inputs(n, cin, cout, h, w, dev)
    skip = skip if skip_add and cin == cout else None
    packed = op.pack_weight(wt)
    ref = library(x.double(), wt.double(), b.double(), None if skip is None else skip.double())
    out = {"kernel_error": None, "kernel_ms": None, "floor_ms": None}
    planned = cout % 32 == 0  # csrc/conv3x3.cu plan()
    with FullPrecision():
        if planned:
            got = op.conv3x3(x, wt, b, skip, packed)
            out["kernel_error"] = relative_error(got, ref)
            out["kernel_ms"] = graph_ms(lambda: op.conv3x3(x, wt, b, skip, packed), iters,
                                        graphs)
        out["library_error"] = relative_error(library(x, wt, b, skip), ref)
        torch.backends.cudnn.benchmark = False
        out["library_ms"] = graph_ms(lambda: library(x, wt, b, skip), iters, graphs)
        torch.backends.cudnn.benchmark = True
        try:
            out["library_best_ms"] = graph_ms(lambda: library(x, wt, b, skip), iters, graphs)
        finally:
            torch.backends.cudnn.benchmark = False
        one = x[:1].contiguous(), None if skip is None else skip[:1].contiguous()
        if planned:
            out["floor_ms"] = graph_ms(lambda: op.conv3x3(one[0], wt, b, one[1], packed),
                                       iters, graphs)
    flops = 2.0 * n * h * w * 9 * cin * cout
    out["bound_ms"] = flops / PEAK_F32 * 1e3
    out["roofline"] = 100.0 * out["bound_ms"] / out["kernel_ms"] if planned else None
    out["kernel_faster"] = planned and out["kernel_ms"] < min(out["library_ms"],
                                                              out["library_best_ms"])
    f32 = torch.float32
    out["routed_to_kernel"] = op.takes_kernel(f32, f32, f32, (3, 3), (1, 1), (1, 1), None,
                                              (n, cin, cout, h, w))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--graphs", type=int, default=5)
    ap.add_argument("--only", default=None, help="one game's shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv3x3_cost: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(profiling.card_line(dev), flush=True)
    for game, n, cin, cout, h, w in SHAPES:
        if args.only and game != args.only:
            continue
        for skip_add in ((False, True) if cin == cout else (False,)):
            row = {"game": game, "shape": [n, cin, cout, h, w], "skip": skip_add}
            row.update(measure(n, cin, cout, h, w, skip_add, args.iters, args.graphs, dev))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
