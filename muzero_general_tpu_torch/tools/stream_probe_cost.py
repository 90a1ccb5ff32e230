"""Time of the stream probe's pointer chase (kernel 10) for any checkout, by
one method for all, with the chase's latency floor where the checkout has it.

At the probe's [64, 512, 8, 128] slab (tools/stream_probe.py probe_slab)
and L = --levels and 2L levels, with the port found under --root: holds
`pointer_chase` against `pointer_chase_plain` (1e-5 relative), then times
it three ways, each the median of --graphs samples:
- "ms": device time of one call, a CUDA graph of 20 calls replayed between
  CUDA events (the wrapper's host cost out of the way; the L2 warm);
- "call_ms": one call from Python, CUDA events around 20 calls back to back
  (the larger of the device time and the wrapper's host cost);
- "issue_us": the host's time to issue one call (a wall clock around 20
  calls, no wait for the card).
Where the checkout's library exports `stream_probe_floor` (the same chains
followed by the pointer words alone, one thread a lane: the latency floor
of any chained fetch), it checks the rows the chains end on against numpy
and times it as "ms". Prints the card's name and power limit, then one JSON
line.

    python3 muzero_general_tpu_torch/tools/stream_probe_cost.py [--root DIR] [--graphs 9]

Run it by its path, not with -m: the port is imported from --root (by
default the checkout that holds this file) only after the argument is read.
To compare two checkouts, run it once per checkout in one chip call, in the
order parent, change, change, parent.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

REPS = 20  # calls per sample


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]),
                    help="checkout whose muzero_general_tpu_torch is timed")
    ap.add_argument("--graphs", type=int, default=9)
    ap.add_argument("--levels", type=int, default=64)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("stream_probe_cost: no CUDA device")
    from muzero_general_tpu_torch.native import build
    from muzero_general_tpu_torch.tools import stream_probe

    if not pathlib.Path(stream_probe.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"stream_probe_cost: imported {stream_probe.__file__}, not from {root}")

    dev = torch.device("cuda")
    B, N, S, A = 64, 512, 8, 128
    slab_np = stream_probe.probe_slab(B, N, S, A)
    slab = torch.from_numpy(slab_np).to(dev)
    lib = build.load_library("stream_probe")
    floor_fn = getattr(lib, "stream_probe_floor", None)  # None where the source predates it

    def events_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def graph_ms(call):
        samples = []
        for _ in range(args.graphs):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(REPS):
                    call()
            graph.replay()  # warm
            torch.cuda.synchronize()
            samples.append(events_ms(graph.replay) / REPS)
        return statistics.median(samples), samples

    def calls(call):
        for _ in range(REPS):
            call()

    out = {"root": str(root), "shape": [B, N, S, A], "levels": {}}
    for L in (args.levels, 2 * args.levels):
        levels = torch.tensor([L], dtype=torch.int32, device=dev)
        got = stream_probe.pointer_chase(levels, slab)
        want = stream_probe.pointer_chase_plain(levels, slab)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        if not rel <= 1e-5:
            raise SystemExit(f"stream_probe_cost: pointer_chase at L={L} differs from its plain "
                             f"version by {rel!r} relative")
        chase = lambda: stream_probe.pointer_chase(levels, slab)  # noqa: E731
        ms, samples = graph_ms(chase)
        call_ms, issue_us = [], []
        for _ in range(args.graphs):
            torch.cuda.synchronize()
            call_ms.append(events_ms(lambda: calls(chase)) / REPS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls(chase)
            issue_us.append((time.perf_counter() - t0) / REPS * 1e6)
            torch.cuda.synchronize()
        entry = {"ms": ms, "per_level_us": 1e3 * ms / L, "samples_ms": samples,
                 "call_ms": statistics.median(call_ms),
                 "call_per_level_us": 1e3 * statistics.median(call_ms) / L,
                 "issue_us": statistics.median(issue_us), "max_rel_err": rel}
        if floor_fn is not None:
            cur = torch.empty((B,), dtype=torch.int32, device=dev)

            def floor():
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = floor_fn(levels.data_ptr(), slab.data_ptr(), cur.data_ptr(), B, N, S * A,
                              stream)
                if rc:
                    raise SystemExit(f"stream_probe_cost: stream_probe_floor failed ({rc}): "
                                     f"{lib.stream_probe_error_string(rc).decode()}")

            floor()
            rows = np.arange(B) % 7
            for _ in range(L):
                rows = np.clip(slab_np[np.arange(B), rows, 0, 0].astype(np.int64), 0, N - 1)
            if not np.array_equal(cur.cpu().numpy(), rows):
                raise SystemExit(f"stream_probe_cost: the latency floor's chains end on other "
                                 f"rows than numpy's at L={L}")
            f_ms, f_samples = graph_ms(floor)
            entry["latency_floor"] = {"ms": f_ms, "per_level_us": 1e3 * f_ms / L,
                                      "samples_ms": f_samples}
        out["levels"][L] = entry
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
