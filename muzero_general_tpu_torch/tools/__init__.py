"""The port's tools, each `python -m muzero_general_tpu_torch.tools.<name>`
(on the card unless `--device cpu`): the counterparts of the repo's tools/
(trace_search, trace_train, resnet_profile, hidden_store_bench, gpu_parity
for tpu_parity, device_replay_bench, connect4_gate, retest_snapshots,
gumbel_proof, lander_curve, conv_probe, stream_probe) with the shared trace
parse in profiling.py, and the port's own cost tools (tree_kernel_cost,
stream_descend_cost, stream_probe_cost, float64_check)."""
