"""The conv probe's kernels (muzero_general_tpu_torch/tools/conv_probe.py)
against the JAX probe's (tools/conv_probe.py, loaded by file path: tools/
has no __init__.py): each plain version against the Pallas kernel it
stands for, run in interpret mode, and against the probe's xla_conv.

Both sides get the same numpy inputs, rounded to the dtype once.
Tolerances, as max |d| / max |ref|: bfloat16 BF16_TOL = 8e-3, one bfloat16
ulp (2^-8) with room for a rounding flip where an output sits just under a
power of two: both sides multiply bfloat16 operands exactly and add in
float32, but in another order, and the result is rounded to bfloat16 once,
so a sum that lands near a rounding boundary can round the other way.
float32 F32_TOL = 1e-5: float32 sums of up to 9C = 288 products in another
order.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from muzero_general_tpu_torch.tools import conv_probe

BF16_TOL = 8e-3  # see the module docstring
F32_TOL = 1e-5
TOL = {"bfloat16": BF16_TOL, "float32": F32_TOL}
REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_probe():
    spec = importlib.util.spec_from_file_location("jax_conv_probe", REPO / "tools" / "conv_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _inputs(B, H, W, C, dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, H, W, C)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, C)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(1, C)) * 0.1).astype(np.float32)
    jax_in = tuple(jnp.asarray(a, jnp.dtype(dtype)) for a in (x, w, b))
    torch_in = tuple(torch.from_numpy(a).to(conv_probe.DTYPES[dtype]) for a in (x, w, b))
    return jax_in, torch_in


@pytest.mark.parametrize("shape", [(4, 5, 5, 16), (2, 6, 7, 32)], ids=["4x5x5x16", "2x6x7x32"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_versions_match_the_pallas_kernels_and_xla_conv(dtype, shape):
    probe = _jax_probe()
    B, H, W, C = shape
    (jx, jw, jb), (x, w, b) = _inputs(B, H, W, C, dtype, seed=sum(shape))
    jdt = jnp.dtype(dtype)
    want_9dot = probe.build_pallas(B, H, W, C, jdt, interpret=True)(jx, jw.reshape(9, C, C), jb)
    want_im2col = probe.build_pallas_im2col(B, H, W, C, jdt, blocks=2, interpret=True)(
        jx, jw.reshape(9 * C, C), jb)
    want_xla = probe.xla_conv(jx, jw, jb[0])
    assert want_9dot.dtype == want_im2col.dtype == jdt

    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    before = (conv_probe.conv_9dot.launches, conv_probe.conv_im2col.launches)
    got_9dot = conv_probe.conv_9dot(xp, w.reshape(9, C, C), b)
    got_im2col = conv_probe.conv_im2col(xp, w.reshape(9 * C, C), b)
    # CPU tensors take the plain versions and count no launch.
    assert (conv_probe.conv_9dot.launches, conv_probe.conv_im2col.launches) == before
    torch.testing.assert_close(got_9dot, conv_probe.conv_9dot_plain(xp, w.reshape(9, C, C), b),
                               rtol=0, atol=0)
    for got in (got_9dot, got_im2col):
        assert got.dtype == conv_probe.DTYPES[dtype] and got.shape == (B, H, W, C)
    tol = TOL[dtype]
    assert _rel(got_9dot.float(), want_9dot) <= tol
    assert _rel(got_im2col.float(), want_im2col) <= tol
    assert _rel(got_9dot.float(), want_xla) <= tol
    assert _rel(got_im2col.float(), want_xla) <= tol
    # The yardstick computes the same function.
    lib = conv_probe.library_conv(x, conv_probe.library_weight(w), b[0])
    assert _rel(lib.float(), want_xla) <= tol


def test_padded_output_writes_the_interior_only():
    (_, _, _), (x, w, b) = _inputs(2, 4, 3, 16, "float32", seed=1)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.full_like(xp, 7.0)
    got = conv_probe.conv_im2col(xp, w.reshape(9 * 16, 16), b, out)
    assert got is out
    torch.testing.assert_close(out[:, 1:-1, 1:-1], conv_probe.conv_im2col(xp, w.reshape(144, 16), b))
    border = torch.ones_like(out, dtype=torch.bool)
    border[:, 1:-1, 1:-1] = False
    assert bool((out[border] == 7.0).all())


def test_wrappers_reject_bad_inputs():
    (_, _, _), (x, w, b) = _inputs(2, 4, 4, 16, "float32", seed=2)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    w9 = w.reshape(9, 16, 16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        conv_probe.conv_9dot(xp.double(), w9.double(), b.double())
    with pytest.raises(ValueError, match="dtype"):
        conv_probe.conv_9dot(xp, w9.bfloat16(), b)
    with pytest.raises(ValueError, match="shape"):
        conv_probe.conv_im2col(xp, w9, b)
    with pytest.raises(ValueError, match="multiple of 16"):
        conv_probe.conv_9dot(xp[..., :8].contiguous(), w9[:, :8, :8].contiguous(), b[:, :8])
    with pytest.raises(ValueError, match="out must be"):
        conv_probe.conv_9dot(xp, w9, b, torch.empty((2, 5, 5, 16)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv_probe.conv_9dot(xp.to("meta"), w9.to("meta"), b.to("meta"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_probe_entry_point_checks_on_the_cpu(dtype, capsys):
    result = conv_probe.main(["--B", "2", "--H", "5", "--W", "4", "--C", "32", "--dtype", dtype,
                              "--device", "cpu"])
    assert set(result["errors"]) == {"conv_9dot", "conv_im2col"}
    assert max(result["errors"].values()) < conv_probe.LIBRARY_TOL
    assert "us_per_conv" not in result  # no timing off the card
    assert "plain version" in capsys.readouterr().out
