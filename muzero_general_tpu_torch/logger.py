"""TensorBoard metrics logging (port of logger.py).

Writes the same 14 scalars under the same tags as the reference's logging
loop (reference muzero.py:268-328), the training-steps-per-self-played-step
ratio, the hyperparameter table and the model summary text
(muzero.py:236-247), through torch.utils.tensorboard, and mirrors the 14
scalars to `metrics.jsonl` line for line as the JAX package does.

tensorboard is imported when a logger is made, and a missing one raises
there: unlike the JAX package, which then writes metrics.jsonl alone, the
port has no silent fallback.
"""

import json
import pathlib

SCALAR_TAGS = [
    ("1.Total_reward/1.Total_reward", "total_reward"),
    ("1.Total_reward/2.Mean_value", "mean_value"),
    ("1.Total_reward/3.Episode_length", "episode_length"),
    ("1.Total_reward/4.MuZero_reward", "muzero_reward"),
    ("1.Total_reward/5.Opponent_reward", "opponent_reward"),
    ("2.Workers/1.Self_played_games", "num_played_games"),
    ("2.Workers/2.Training_steps", "training_step"),
    ("2.Workers/3.Self_played_steps", "num_played_steps"),
    ("2.Workers/4.Reanalysed_games", "num_reanalysed_games"),
    ("2.Workers/6.Learning_rate", "lr"),
    ("3.Loss/1.Total_weighted_loss", "total_loss"),
    ("3.Loss/Value_loss", "value_loss"),
    ("3.Loss/Reward_loss", "reward_loss"),
    ("3.Loss/Policy_loss", "policy_loss"),
]
RATIO_TAG = "2.Workers/5.Training_steps_per_self_played_step_ratio"


class MetricsLogger:
    def __init__(self, results_path, config, model_summary: str = ""):
        from torch.utils.tensorboard import SummaryWriter

        results_path = pathlib.Path(results_path)
        results_path.mkdir(parents=True, exist_ok=True)
        self.counter = 0
        self.writer = SummaryWriter(str(results_path))
        self._jsonl = open(results_path / "metrics.jsonl", "a")
        hp_table = [f"| {key} | {value} |" for key, value in config.__dict__.items()]
        self.writer.add_text(
            "Hyperparameters",
            "| Parameter | Value |\n|-------|-------|\n" + "\n".join(hp_table),
        )
        if model_summary:
            self.writer.add_text("Model summary", model_summary)

    def log(self, info: dict):
        """One point of every scalar from a checkpoint dict."""
        for tag, key in SCALAR_TAGS:
            self.writer.add_scalar(tag, info[key], self.counter)
        self.writer.add_scalar(
            RATIO_TAG, info["training_step"] / max(1, info["num_played_steps"]), self.counter
        )
        self._jsonl.write(json.dumps({k: float(info[k]) for _, k in SCALAR_TAGS}) + "\n")
        self._jsonl.flush()
        self.counter += 1

    def close(self):
        self.writer.close()
        self._jsonl.close()
