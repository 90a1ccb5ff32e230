"""The port's hyperparameter search (muzero_general_tpu_torch/search.py) and
MuZero's device groups against the JAX package's search.py.

The candidate sequence is numpy's (default_rng(0)) on both sides, so the
initial sample and every mutation are equal float for float. The device
slices are computed on handed-in fleets, as tests/test_search.py computes
them on JAX's 8-device CPU mesh. A two-candidate search runs end to end on
the CPU both ways: on a one-device fleet the slices collide and the two
candidates train one after the other; on a fleet of two distinct CPU
devices (`cpu` and `cpu:0`, which MuZero treats as separate device groups)
they train at once on the thread pool. Each run writes the best
checkpoint and parameters under its results root.
"""

import threading

import numpy as np
import pytest
import torch

from muzero_general_tpu import search as jax_search
from muzero_general_tpu_torch import MuZero, checkpoint, search
from muzero_general_tpu_torch.muzero import device_fleet
from test_torch_muzero import one_torch_thread  # noqa: F401 (a module fixture)

LINEAR = {"lr_init": ("linear", 1e-3, 0.1), "discount": ("linear", 0.95, 0.9999),
          "value_loss_weight": ("log", 0.1, 1.0)}
TINY = {"training_steps": 2, "parallel_games": 4, "selfplay_chunk_moves": 4, "batch_size": 8,
        "max_moves": 12, "num_simulations": 4, "fused_train_steps": 1, "batch_prefetch": False,
        "use_last_model_value": False, "checkpoint_interval": 2, "td_steps": 5,
        "num_unroll_steps": 3}
PARAMS = {"lr_init": ("log", 1e-3, 1e-1)}


@pytest.mark.parametrize("parametrization", [None, LINEAR], ids=["default", "linear"])
def test_candidate_sequence_matches_jax(parametrization):
    mine = parametrization or search.DEFAULT_PARAMETRIZATION
    theirs = parametrization or jax_search.DEFAULT_PARAMETRIZATION
    assert mine == theirs
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    values, jvalues = search._sample_initial(mine, rng), jax_search._sample_initial(theirs, jrng)
    assert values == jvalues
    for sigma in [0.5] * 19 + [2.0]:  # 20 draws; the last wide enough to clip
        values = search._mutate(values, mine, rng, sigma=sigma)
        jvalues = jax_search._mutate(jvalues, theirs, jrng, sigma=sigma)
        assert values == jvalues and all(type(v) is float for v in values.values())
        for name, (_, lo, hi) in mine.items():
            assert lo <= values[name] <= hi


def test_device_slices_on_handed_in_fleets():
    fleet = [torch.device("cuda", i) for i in range(8)]
    for n in (2, 3, 8, 11):
        slices = search._device_slices(n, fleet)
        assert len(slices) == n
        per = len(fleet) // n if n <= len(fleet) else 1
        assert all(len(s) == per for s in slices)
        assert search._slices_disjoint(slices) == (n <= len(fleet))
        assert search._slices_disjoint(slices) == jax_search._slices_disjoint(slices)
    # JAX's slices of its 8-device test mesh, the same rule over its fleet.
    import jax

    jfleet = jax.devices()
    for n in (2, 3, 11):
        assert jax_search._device_slices(n) == search._device_slices(n, jfleet)
    cpu = search._device_slices(2, device="cpu")
    assert cpu == [[torch.device("cpu")], [torch.device("cpu")]]
    assert not search._slices_disjoint(cpu)
    assert device_fleet("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            search._device_slices(2)


def test_muzero_device_groups_pin_the_instance():
    mz = MuZero("cartpole", devices=[torch.device("cpu", 0)])
    assert mz.device == torch.device("cpu", 0) and mz._devices == [torch.device("cpu", 0)]
    assert MuZero("cartpole", split_resources_in=2, slice_index=1,
                  device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="device group"):
        MuZero("cartpole", devices=["cpu"], device="meta")


@pytest.mark.parametrize("route", ["sequential", "thread_pool"])
def test_two_candidate_search_runs_on_the_cpu(route, tmp_path, monkeypatch):
    fleet = ([torch.device("cpu")] if route == "sequential"
             else [torch.device("cpu"), torch.device("cpu", 0)])
    slices = search._device_slices(2, fleet)
    assert search._slices_disjoint(slices) == (route == "thread_pool")
    runs, active = [], {"now": 0, "max": 0}
    lock = threading.Lock()
    run_candidate = search._run_candidate

    def tracking_run(game, values, overrides, devices, num_tests, path):
        with lock:
            active["now"] += 1
            active["max"] = max(active["max"], active["now"])
            runs.append((dict(values), list(devices), threading.current_thread().name))
        try:
            return run_candidate(game, values, overrides, devices, num_tests, path)
        finally:
            with lock:
                active["now"] -= 1

    monkeypatch.setattr(search, "_run_candidate", tracking_run)
    best = search.one_plus_one_search("cartpole", parametrization=PARAMS, budget=2,
                                      parallel_experiments=2, num_tests=1, base_overrides=TINY,
                                      results_root=tmp_path / "search", fleet=fleet)
    # The generation is the incumbent and one mutation of it, JAX's draws.
    rng = np.random.default_rng(0)
    first = jax_search._sample_initial(PARAMS, rng)
    assert [values for values, _, _ in runs] == [first, jax_search._mutate(first, PARAMS, rng)]
    assert [devices for _, devices, _ in runs] == slices
    main = threading.main_thread().name
    if route == "sequential":
        assert active["max"] == 1 and {name for _, _, name in runs} == {main}
    else:
        assert main not in {name for _, _, name in runs}
    assert best in [values for values, _, _ in runs]
    root = tmp_path / "search"
    assert (root / "best_parameters.txt").read_text() == str(best)
    ck = checkpoint.load_checkpoint(root / "model.checkpoint")
    assert ck["training_step"] == TINY["training_steps"]
    assert ck["lr"] == pytest.approx(best["lr_init"], rel=1e-3)  # decayed over 2 steps
    for i in range(2):
        assert (root / f"trial_{i:03d}" / "model.checkpoint").exists()
