"""The bf16 self-play driver against the JAX package's on the port's kernel
and stream search routes (through the kernels' plain versions on the CPU):
the cases of tests/test_torch_bf16.py's test_driver_bf16_matches_jax_driver
for those routes, with its fixture, check and tolerances, in a file of
their own so that the two halves run on two test workers.
"""

import pytest

from test_torch_bf16 import (  # noqa: F401 (jax_bf16_driver_records: a module fixture)
    check_driver_bf16,
    jax_bf16_driver_records,
)


@pytest.mark.parametrize("route", ["kernels", "stream"])
@pytest.mark.parametrize("acts", [False, True], ids=["f32_acts", "bf16_acts"])
def test_driver_bf16_matches_jax_driver(jax_bf16_driver_records, route, acts, monkeypatch):
    check_driver_bf16(jax_bf16_driver_records, route, acts, monkeypatch)
