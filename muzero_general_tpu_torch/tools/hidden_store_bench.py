"""Per-simulation hidden-store update strategies on the card (port of
tools/hidden_store_bench.py).

The search needs, per simulation: read row `parent` (per lane) of an
[N, B, F] store, and write row `new_node`. One run builds the store
(zeros, row 0 = ones) and runs `--sims` simulations, each gathering row 0
of every lane and writing row i + 1 = h * 1.000001. Variants:

  value   -- the write out of place (`index_copy`), a new store each
             simulation: the counterpart of JAX's `.at[node].set` carry,
             which copies the whole store (553 MB at the default size)
  inplace -- `store[node].copy_(leaf)`: the counterpart of JAX's `ref`
             (an in-place update)
  kernel  -- `ops/hidden_store.write_node_hidden`, the hand-written row
             write (csrc/hidden_store.cu, kernel 7; JAX's `pallas`
             variant, the one-row Pallas kernel)

Each is timed as the mean of 3 runs after one warm-up, on the host clock
after a device synchronize (the JAX tool pulled a value to the host). The
three final stores must be bit-equal, or the tool exits 1.

Usage (on the card; `--device cpu` checks the plumbing on the CPU):
    python -m muzero_general_tpu_torch.tools.hidden_store_bench [--N 201] \\
        [--B 256] [--F 2688] [--sims 200]

Prints the card's name and power limit, the JAX tool's line a variant
(`<name>: <ms> ms for <sims> sims (<us> us/sim)`), kernel 7's launches and
the stores' equality.
"""

import argparse
import sys

import torch

from muzero_general_tpu_torch.device import resolve_device
from muzero_general_tpu_torch.tools import profiling

VARIANTS = ("value", "inplace", "kernel")
REPS = 3  # timed runs of each variant, after one warm-up


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=201)
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--F", type=int, default=2688)
    ap.add_argument("--sims", type=int, default=200)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def variants(N, B, F, sims, device):
    """{name: fn() -> (final store, the sum of the gathered values)}."""
    from muzero_general_tpu_torch.ops.hidden_store import write_node_hidden

    h0 = torch.ones((B, F), device=device)
    b_idx = torch.arange(B, device=device)
    parent = torch.zeros((B,), dtype=torch.long, device=device)
    nodes = torch.arange(N, dtype=torch.int32, device=device)

    def loop(write):
        store = torch.zeros((N, B, F), device=device)
        store[0] = h0
        outs = []
        for i in range(sims):
            h = store[parent, b_idx]
            store = write(store, i + 1, h * 1.000001)
            outs.append(h[:, 0])
        return store, torch.stack(outs).sum()

    def value(store, node, row):
        return store.index_copy(0, nodes[node:node + 1].long(), row[None])

    def inplace(store, node, row):
        store[node].copy_(row)
        return store

    def kernel(store, node, row):
        return write_node_hidden(store, nodes[node], row)

    return {name: (lambda w=w: loop(w)) for name, w in
            (("value", value), ("inplace", inplace), ("kernel", kernel))}


def run(args, print_fn=print):
    """Returns {"ms": {variant: ms a run}, "us_per_sim", "stores_equal",
    "launches" (kernel 7's over the run)}."""
    device = resolve_device(args.device)
    print_fn(profiling.card_line(device))
    before = profiling.launch_counts()
    stores, ms = {}, {}
    with torch.no_grad():
        for name, fn in variants(args.N, args.B, args.F, args.sims, device).items():
            stores[name] = fn()[0]  # warm-up, and the store compared below
            dt = profiling.timeit(fn, device, REPS)
            ms[name] = dt * 1e3
            print_fn(f"{name}: {dt * 1e3:.1f} ms for {args.sims} sims "
                     f"({dt / args.sims * 1e6:.0f} us/sim)")
    launches = profiling.launches_since(before).get("write_node_hidden", 0)
    equal = all(torch.equal(stores["value"], stores[name]) for name in VARIANTS[1:])
    print_fn(f"store [{args.N}, {args.B}, {args.F}] float32 "
             f"({args.N * args.B * args.F * 4 / 1e6:.0f} MB); write_node_hidden launches "
             f"{launches}; the three final stores " + ("bit-equal" if equal else "DIFFER"))
    return {"ms": ms, "us_per_sim": {k: v * 1e3 / args.sims for k, v in ms.items()},
            "stores_equal": equal, "launches": launches}


def main(argv=None):
    return 0 if run(parse_args(argv))["stores_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
