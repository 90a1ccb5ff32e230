"""Hyperparameter search (port of muzero_general_tpu/search.py).

The reference drives nevergrad's OnePlusOne optimizer over full training
runs, `parallel_experiments` of them at a time, each claiming 1/N of the
GPUs via `split_resources_in` (reference muzero.py:495-581, :694-707).
As in the JAX package, the same loop is implemented directly as a
(1+λ)-evolution strategy: each generation mutates the incumbent into
λ = parallel_experiments candidates, trains/tests them CONCURRENTLY — each
experiment pinned to its own disjoint slice of the device fleet (the
counterpart of the reference's fractional-GPU scheduling,
muzero.py:142-153) — and keeps the best if it improves. λ = 1 reduces to
the reference's default (1+1) behavior. Parametrization:

    {"lr_init": ("log", 1e-4, 0.1), "discount": ("linear", 0.95, 0.9999)}

The fleet is every CUDA card (`cuda:i`), or the CPU when the caller asks
for it; a slice is a MuZero device group: one device, or several, which
the candidate's train() runs as a mesh, one rank a device
(MuZero(devices=slice)). On one card λ > 1 collides and runs
sequentially, as the JAX package does on one chip.
"""

import datetime
import math
import pathlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from muzero_general_tpu_torch import checkpoint as ckpt_lib
from muzero_general_tpu_torch.config import load_game_module


DEFAULT_PARAMETRIZATION = {
    "lr_init": ("log", 1e-4, 0.1),
    "discount": ("log", 0.95, 0.9999),
}


def _sample_initial(parametrization, rng):
    values = {}
    for name, (scale, lo, hi) in parametrization.items():
        if scale == "log":
            values[name] = float(math.exp(rng.uniform(math.log(lo), math.log(hi))))
        else:
            values[name] = float(rng.uniform(lo, hi))
    return values


def _mutate(values, parametrization, rng, sigma=0.5):
    out = {}
    for name, (scale, lo, hi) in parametrization.items():
        v = values[name]
        if scale == "log":
            v = math.exp(
                np.clip(math.log(v) + rng.normal(0, sigma), math.log(lo), math.log(hi))
            )
        else:
            v = float(np.clip(v + rng.normal(0, sigma * (hi - lo)), lo, hi))
        out[name] = float(v)
    return out


def _device_slices(n_slots, fleet=None, device=None):
    """Split the device fleet into n_slots disjoint groups (contiguous).
    With fewer devices than slots, experiments share devices round-robin.
    fleet: the devices (default: muzero.device_fleet(device), every card or
    the CPU)."""
    if fleet is None:
        from muzero_general_tpu_torch.muzero import device_fleet

        fleet = device_fleet(device)
    fleet = list(fleet)
    if len(fleet) >= n_slots:
        per = len(fleet) // n_slots
        return [fleet[i * per : (i + 1) * per] for i in range(n_slots)]
    return [[fleet[i % len(fleet)]] for i in range(n_slots)]


def _slices_disjoint(slices):
    """True iff no device appears in two slices (safe to run concurrently)."""
    seen = set()
    for s in slices:
        for d in s:
            if d in seen:
                return False
            seen.add(d)
    return True


def _run_candidate(game_name, values, base_overrides, devices, num_tests, results_path):
    """Train + test one candidate on its device slice; returns
    (score, checkpoint)."""
    from muzero_general_tpu_torch.muzero import MuZero

    overrides = dict(base_overrides or {})
    overrides.update(values)
    overrides["results_path"] = str(results_path)
    mz = MuZero(game_name, overrides, devices=devices)
    mz.train(log_in_tensorboard=False)
    score = mz.test(num_tests=num_tests)
    return score, mz.checkpoint


def one_plus_one_search(game_name, parametrization=None, budget=20,
                        parallel_experiments=1, num_tests=10,
                        base_overrides=None, results_root=None, device=None,
                        fleet=None):
    """(1+λ)-ES over full train+test runs; returns the best override dict.

    Each generation evaluates λ = parallel_experiments mutated candidates
    concurrently, each on a disjoint 1/λ slice of the devices (reference
    muzero.py:495-581: nevergrad asks `parallel_experiments` candidates and
    runs that many MuZero instances at once with split GPU budgets). The
    total number of candidate evaluations is `budget`.

    When the fleet has fewer devices than candidates the slices collide; in
    that case the generation runs SEQUENTIALLY, one experiment on the
    device at a time (the reference at 1 GPU likewise serializes:
    nevergrad just waits for the single running experiment, reference
    muzero.py:530-548).

    results_root: directory for per-trial artifacts; defaults to a fresh
    timestamped `results/<game>/search-<stamp>/` so repeated searches never
    overwrite each other's trials or the saved best checkpoint.
    device: the fleet's kind, as MuZero's (None: the cards; "cpu");
    fleet: the devices themselves (default: from `device`).
    """
    parametrization = parametrization or DEFAULT_PARAMETRIZATION
    lam = max(1, int(parallel_experiments))
    rng = np.random.default_rng(0)
    if results_root is None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d--%H-%M-%S")
        results_root = load_game_module(game_name).MuZeroConfig(
        ).default_results_path(game_name).parent / f"search-{stamp}"
    results_root = pathlib.Path(results_root)
    slices = _device_slices(lam, fleet, device)

    best_values, best_score, best_checkpoint = None, -np.inf, None
    incumbent = _sample_initial(parametrization, rng)
    trial = 0
    while trial < budget:
        gen = []
        for _ in range(min(lam, budget - trial)):
            gen.append(
                incumbent
                if trial == 0 and not gen
                else _mutate(incumbent, parametrization, rng)
            )
        print(f"\n[search {trial + 1}..{trial + len(gen)}/{budget}] {gen}")
        if len(gen) > 1 and _slices_disjoint(slices[: len(gen)]):
            with ThreadPoolExecutor(max_workers=len(gen)) as pool:
                futures = [
                    pool.submit(
                        _run_candidate, game_name, cand, base_overrides,
                        slices[i], num_tests,
                        results_root / f"trial_{trial + i:03d}",
                    )
                    for i, cand in enumerate(gen)
                ]
                outcomes = [f.result() for f in futures]
        else:
            # Colliding slices (fewer devices than candidates): evaluate
            # sequentially, one experiment on the device at a time.
            outcomes = [
                _run_candidate(
                    game_name, cand, base_overrides, slices[i], num_tests,
                    results_root / f"trial_{trial + i:03d}",
                )
                for i, cand in enumerate(gen)
            ]
        for cand, (score, checkpoint) in zip(gen, outcomes):
            print(f"[search] {cand} -> score {score:.2f}")
            if score > best_score:
                best_values, best_score = dict(cand), score
                best_checkpoint = checkpoint
                incumbent = dict(cand)
        trial += len(gen)

    if best_checkpoint is not None:
        results_root.mkdir(parents=True, exist_ok=True)
        ckpt_lib.save_checkpoint(best_checkpoint, results_root / "model.checkpoint")
        (results_root / "best_parameters.txt").write_text(str(best_values))
    print(f"\nBest parameters: {best_values} (score {best_score:.2f})")
    return best_values
