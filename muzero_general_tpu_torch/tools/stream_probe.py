"""The stream probe (port of tools/stream_probe.py): the bare primitive under
the gomoku stream descent, a per-lane pointer chase through a float32 slab
[B, N, S, A], as a hand-written CUDA kernel (csrc/stream_probe.cu).

Each of L levels fetches row slab[b, cur_b] for every lane b, adds the
row's sum to the lane's float32 accumulator and takes the next row index
from row[0, 0] (truncated to int, clamped into [0, N)); chains start at row
b % 7. The default [64, 512, 8, 128] is within a few rows of gomoku's packed
slab [64, 402, 8, 128]. `pointer_chase(levels, slab)` launches the kernel on
a CUDA slab and counts the launch, and runs `pointer_chase_plain` on a CPU
one.

Usage:
    python -m muzero_general_tpu_torch.tools.stream_probe [--B 64] [--N 512] \\
        [--S 8] [--A 128] [--levels 64] [--device cuda]

It builds the probe's slab and pointer plane (next row = (n * 7 + b) % N),
checks the chase against a float64 numpy reference at rtol 1e-4 for L and
2L levels, and on the card prints the device time per call (CUDA graphs of
20 calls), per level and per lane-row, and the time of a call from Python.
"""

import argparse

import numpy as np
import torch

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.ops.mcts_kernels import _check, _raise_on, _route

REFERENCE_RTOL = 1e-4  # the probe's check (tools/stream_probe.py:106-119)


def pointer_chase_plain(levels, slab):
    """The kernel's plain version: levels an int32 tensor [1], slab [B, N,
    S, A] float32. Returns acc [B, 1] float32."""
    B, N = slab.shape[:2]
    lanes = torch.arange(B, device=slab.device)
    cur = (lanes % 7).clamp(max=N - 1)
    acc = torch.zeros((B,), dtype=torch.float32, device=slab.device)
    for _ in range(int(levels.reshape(-1)[0])):
        rows = slab[lanes, cur]  # [B, S, A]
        acc = acc + rows.sum(dim=(1, 2))
        cur = rows[:, 0, 0].to(torch.int64).clamp(0, N - 1)
    return acc[:, None]


def pointer_chase(levels, slab):
    """Chase every lane's chain for levels[0] levels: the CUDA kernel for a
    CUDA slab (levels an int32 [1] tensor on the card, read there),
    pointer_chase_plain for a CPU one. slab [B, N, S, A] float32, contiguous,
    S * A a multiple of 4. Returns acc [B, 1] float32."""
    device = slab.device
    if _route("pointer_chase", device) == "cpu":
        return pointer_chase_plain(levels, slab)
    if slab.dim() != 4:
        raise ValueError(f"slab must be [B, N, S, A], got {tuple(slab.shape)}")
    B, N, S, A = slab.shape
    if (S * A) % 4 or slab.data_ptr() % 16:
        raise ValueError("slab rows must be whole 16-byte words, 16-byte aligned")
    _check("slab", slab, torch.float32, tuple(slab.shape), device)
    _check("levels", levels, torch.int32, (1,), device)
    acc = torch.empty((B, 1), dtype=torch.float32, device=device)

    from muzero_general_tpu_torch.native import build

    lib = build.load_library("stream_probe")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.stream_probe_chase(levels.data_ptr(), slab.data_ptr(), acc.data_ptr(), B, N,
                                    S * A, stream)
    _raise_on(rc, lib.stream_probe_error_string, "stream_probe_chase")
    pointer_chase.launches += 1
    return acc


pointer_chase.launches = 0  # kernel launches, counted where the kernel is launched


def probe_slab(B, N, S, A, seed=0):
    """The probe's slab as numpy float32: uniform [0, 1) rows whose [0, 0]
    entry holds the pointer plane, next row (n * 7 + b) % N."""
    rng = np.random.default_rng(seed)
    slab = rng.uniform(0, 1, (B, N, S, A)).astype(np.float32)
    slab[:, :, 0, 0] = (np.arange(N)[None, :] * 7 + np.arange(B)[:, None]) % N
    return slab


def reference(slab, L):
    """The probe's float64 numpy reference: acc [B]."""
    B = slab.shape[0]
    acc = np.zeros((B,), np.float64)
    cur = np.arange(B) % 7
    for _ in range(L):
        rows = slab[np.arange(B), cur]
        acc += rows.sum(axis=(1, 2), dtype=np.float64)
        cur = rows[:, 0, 0].astype(np.int64)
    return acc


def _graph_of(levels, slab, calls):
    """A CUDA graph of `calls` chases and its replay, which counts the
    `calls` launches each replay runs (capture only records them)."""
    graph = torch.cuda.CUDAGraph()
    recorded = pointer_chase.launches
    with torch.cuda.graph(graph):
        for _ in range(calls):
            pointer_chase(levels, slab)
    pointer_chase.launches = recorded

    def replay():
        graph.replay()
        pointer_chase.launches += calls

    return replay


def _events_ms(fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def chase_times(levels, slab, reps=20, graphs=5):
    """The chase's time on the card, in us: "us" the device time of one call
    (the median of `graphs` replays of a CUDA graph of `reps` calls, so the
    wrapper's host cost is out of the way), "call_us" one call from Python
    (CUDA events over `reps` calls back to back: the larger of the device
    time and the wrapper's host cost)."""
    def calls():
        for _ in range(reps):
            pointer_chase(levels, slab)

    torch.cuda.synchronize()
    call_ms = _events_ms(calls) / reps
    replay = _graph_of(levels, slab, reps)
    replay()
    torch.cuda.synchronize()
    device_ms = sorted(_events_ms(replay) / reps for _ in range(graphs))[graphs // 2]
    return {"us": device_ms * 1e3, "call_us": call_ms * 1e3}


def one_call_ms(levels, slab, cold, reps=5):
    """One chase (a CUDA graph of one launch) between CUDA events, the median
    of `reps`: each after a warm-up call, or, when `cold`, after a 256 MB
    write to another buffer, which evicts the slab from the L2."""
    replay = _graph_of(levels, slab, 1)
    flush = torch.empty((64 << 20,), dtype=torch.float32, device=slab.device)
    out = []
    for i in range(reps):
        if cold:
            flush.fill_(float(i))
        else:
            replay()
        out.append(_events_ms(replay))
    return sorted(out)[reps // 2]


def main(argv=None):
    """The probe's entry point; returns {L: {"correct", "max_rel_err", and on
    the card "us", "call_us", "per_level_us", "per_lane_row_ns"}}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--N", type=int, default=512)
    ap.add_argument("--S", type=int, default=8)
    ap.add_argument("--A", type=int, default=128)
    ap.add_argument("--levels", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B = args.B
    slab_np = probe_slab(B, args.N, args.S, args.A)
    slab = torch.from_numpy(slab_np).to(device)
    results = {}
    for L in (args.levels, 2 * args.levels):
        levels = torch.tensor([L], dtype=torch.int32, device=device)
        out = pointer_chase(levels, slab)[:, 0].double().cpu().numpy()
        ref = reference(slab_np, L)
        ok = bool(np.allclose(out, ref, rtol=REFERENCE_RTOL))
        result = {"correct": ok, "max_rel_err": float(np.max(np.abs(out - ref) / np.abs(ref)))}
        line = f"L={L}: correct={ok} (max rel err {result['max_rel_err']:.2e})"
        if device.type == "cuda":
            result.update(chase_times(levels, slab))
            dt = result["us"] / 1e6
            result.update(per_level_us=dt / L * 1e6, per_lane_row_ns=dt / L / B * 1e9)
            line += (f" time={result['us']:.2f} us (device; {result['call_us']:.2f} us a call "
                     f"from Python) per-level={result['per_level_us']:.4f} us "
                     f"per-lane-row={result['per_lane_row_ns']:.2f} ns")
        print(line)
        if not ok:
            raise SystemExit(f"stream_probe: the chase disagrees with the reference at L={L}")
        results[L] = result
    return results


if __name__ == "__main__":
    main()
