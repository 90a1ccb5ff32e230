"""The stream probe's pointer chase (muzero_general_tpu_torch/tools/
stream_probe.py) against the JAX probe's kernel (tools/stream_probe.py
`build`, loaded by file path, run in interpret mode) and against the
probe's float64 numpy reference, at [4, 16, 8, 128] for 5 and 10 levels.

The chase is exact (every pointer is an integer stored in float32), the
sums are not: both sides add 1,024 floats in [0, 1) a row in float32, in
another order. So the accumulators agree to RTOL = 1e-5 relative (observed
below 1e-7), inside the probe's own rtol 1e-4 against the reference.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu_torch.tools import stream_probe

RTOL = 1e-5  # see the module docstring
REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_probe():
    spec = importlib.util.spec_from_file_location("jax_stream_probe",
                                                  REPO / "tools" / "stream_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("L", [5, 10])
def test_plain_chase_matches_the_pallas_kernel_and_the_reference(L):
    B, N, S, A = 4, 16, 8, 128
    slab = stream_probe.probe_slab(B, N, S, A)
    want = np.asarray(_jax_probe().build(B, N, S, A, interpret=True)(
        jnp.array([L], jnp.int32), jnp.asarray(slab)))[:, 0]
    before = stream_probe.pointer_chase.launches
    got = stream_probe.pointer_chase(torch.tensor([L], dtype=torch.int32),
                                     torch.from_numpy(slab))
    assert stream_probe.pointer_chase.launches == before  # the CPU takes the plain version
    assert got.shape == (B, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[:, 0].numpy(), stream_probe.reference(slab, L), rtol=RTOL,
                               atol=0)


def test_chase_clamps_pointers_into_the_slab():
    """A pointer outside [0, N) is clamped to the nearest row (the TPU kernel
    would read out of bounds)."""
    B, N = 2, 4
    slab = torch.zeros((B, N, 1, 4))
    slab[:, :, 0, 1] = torch.arange(N, dtype=torch.float32)  # row n sums to n + pointer
    slab[0, 0, 0, 0] = 9.0  # lane 0: row 0 -> 9, clamped to row 3
    slab[0, 3, 0, 0] = -2.0  # row 3 -> -2, clamped to row 0
    slab[1, 1, 0, 0] = 1.0  # lane 1 stays on row 1
    got = stream_probe.pointer_chase_plain(torch.tensor([3], dtype=torch.int32), slab)
    # lane 0: rows 0, 3, 0 -> (9 + 0) + (-2 + 3) + (9 + 0); lane 1: row 1 three times.
    torch.testing.assert_close(got[:, 0], torch.tensor([19.0, 6.0]))


def test_wrapper_rejects_what_it_cannot_run():
    slab = torch.from_numpy(stream_probe.probe_slab(2, 8, 8, 128))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        stream_probe.pointer_chase(torch.tensor([2], dtype=torch.int32).to("meta"),
                                   slab.to("meta"))


def test_probe_entry_point_checks_on_the_cpu(capsys):
    results = stream_probe.main(["--B", "4", "--N", "16", "--levels", "5", "--device", "cpu"])
    assert sorted(results) == [5, 10]
    assert all(r["correct"] and "us" not in r for r in results.values())
    assert "correct=True" in capsys.readouterr().out
