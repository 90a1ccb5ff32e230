"""The benchmark of the PyTorch/CUDA port (muzero_general_tpu_torch): one
cell of BENCHMARK.json run once by `python3 gpubench/run.py`. See
README.md."""
