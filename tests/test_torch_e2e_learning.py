"""End-to-end learning gates of the port (slow), the counterparts of
tests/test_e2e_learning.py. This file imports nothing of JAX, so it also
runs on the card machine, where the suite's conftest (which imports JAX)
is left out and nothing skips the slow tests:

    python -m pytest --noconftest -p no:cacheprovider -s \\
        tests/test_torch_e2e_learning.py -k cartpole

- test_simple_grid_solves: the CPU-scale gate, on the CPU.
- test_cartpole_reaches_ci_bar: the reference's CI bar (reference
  ci-testing.yaml:54-62), on the card: the best test reward >= 250 within
  7,500 training steps at seed 0. "Best" takes the greedy eval lane's
  episode rewards that training logged (metrics.jsonl) and the final
  test(num_tests=5). A graceful stop: `touch <results_path>/STOP`.
"""

import json
import pathlib
import tempfile
import time

import pytest
import torch

from muzero_general_tpu_torch import MuZero


@pytest.mark.slow
def test_simple_grid_solves():
    mz = MuZero(
        "simple_grid",
        {
            "training_steps": 400,
            "batch_size": 32,
            "num_simulations": 10,
            "parallel_games": 16,
            "selfplay_chunk_moves": 6,
            "ratio": 1.0,
            "reanalyse_interval": 50,
        },
        device="cpu",
    )
    mz.config.results_path = pathlib.Path(tempfile.mkdtemp())
    mz.train(log_in_tensorboard=False)
    result = mz.test(num_tests=5)
    # Optimal play reaches the goal every episode: reward 10
    assert result >= 9.9, f"simple_grid not solved: mean test reward {result}"


@pytest.mark.slow
@pytest.mark.gpu
def test_cartpole_reaches_ci_bar():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    results = pathlib.Path(tempfile.mkdtemp())
    mz = MuZero("cartpole", {"training_steps": 7500, "results_path": str(results)})
    t0 = time.perf_counter()
    ck = mz.train()
    train_s = time.perf_counter() - t0
    logged = [json.loads(line) for line in (results / "metrics.jsonl").read_text().splitlines()]
    logged = [x for x in logged if "total_reward" in x]
    best_logged = max(x["total_reward"] for x in logged)
    result = mz.test(num_tests=5)
    best = max(best_logged, result)
    print(json.dumps({
        "cartpole_gate": {
            "training_step": ck["training_step"], "num_played_games": ck["num_played_games"],
            "num_played_steps": ck["num_played_steps"], "train_s": round(train_s, 1),
            "train_steps_per_s": round(ck["training_step"] / train_s, 3),
            "best_logged_greedy_reward": best_logged,
            "final_logged_greedy_reward": logged[-1]["total_reward"],
            "test_mean_reward_5": result, "best": best,
            "phase_time_s": {k: round(v, 2) for k, v in mz.phase_time.items()},
        }
    }))
    assert best >= 250, f"cartpole best test reward {best} < 250"
