"""Check the program's own spans (the port's tracing.py) against a traced
run of a cell: that they lie on the benchmark's clock, and how much of the
profiled call's idle time they cover.

    python3 gpubench/program_check.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout, on the card. It runs the cell as
`run.py --trace 1` does and prints run.py's result line (standard error
gets its notes), then one JSON line:
- `clock`: for each program span `selfplay.chunk` (`train.forward` in
  training) of the profiled call, its start and end against those of the
  benchmark's own span that wraps the same call (`move_loop`, `forward`),
  in microseconds, and for self-play the gap from `move_loop`'s end to the
  start of the program's next span, `selfplay.records` (the benchmark's
  `move_loop` ends with a device synchronize of its own, which the
  program's span does not hold);
- `idle_ms`: the profiled call's idle time by the innermost program span,
  scaled to the unprofiled calls (yardstick/program.py), and `outside_share`,
  the share of it outside every program span;
- `dropped`: records the program's tracer dropped past its cap.
"""

import json
import pathlib
import sys

if __package__ in (None, ""):  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from gpubench import harness, run  # noqa: E402
from gpubench.yardstick import program, trace  # noqa: E402

PAIRS = {"play": ("selfplay.chunk", "move_loop"), "train_steps": ("train.forward", "forward")}


def _take():
    from muzero_general_tpu_torch import tracing

    return tracing.take()


def clock(tr, spans, window_name):
    """[(start - outer start, outer end - end) us] of each program span of
    the pair inside the window, against the benchmark span holding it."""
    name, outer_name = PAIRS[window_name]
    lo, hi = trace.windows(tr, window_name)[0]
    outers = [s for s in tr.spans if s[2] == outer_name and lo <= s[0] and s[1] <= hi]
    rows = []
    for s, e, n in spans:
        if n != name or not lo <= s < hi:
            continue
        outer = min((o for o in outers if o[0] <= e and s <= o[1]),
                    key=lambda o: abs(o[0] - s))
        row = {"start_us": (s - outer[0]) / 1e3, "end_us": (outer[1] - e) / 1e3}
        if window_name == "play":
            nxt = min((b for b, _, m in spans if m == "selfplay.records" and b >= outer[1]),
                      default=None)
            row["next_span_us"] = None if nxt is None else (nxt - outer[1]) / 1e3
        rows.append(row)
    return rows


def main(argv=None):
    args = run.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("gpubench: program_check needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run.run_cell(cell, args.seed % 2**63, args.seconds, True, device, run.T_START)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    print(out.get("note"), file=sys.stderr)
    print(json.dumps(run.result_line(cell, out, True, info)), flush=True)
    r = out["readings"]
    window_name = "train_steps" if "steps" in r["calls"][0] else "play"
    taken = program.taken(r, _take)
    phases = program.idle_by_phase(r, window_name, _take) or {}
    total = sum(phases.values())
    print(json.dumps({
        "workload": cell.name,
        "clock": clock(r["trace"], taken.spans, window_name),
        "idle_ms": {k or "outside program spans": v / 1e6 for k, v in
                    sorted(phases.items(), key=lambda kv: -kv[1])},
        "outside_share": phases.get("", 0.0) / total if total else None,
        "dropped": taken.dropped,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
