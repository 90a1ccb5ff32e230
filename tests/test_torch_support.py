"""The port's config and support codecs against the JAX package.

Inputs are made with numpy from a seed and fed to both. The codecs agree to
atol 1e-6 (float32 elementwise math in two libraries: a few ULP at values of
order 1). The decoders through h^-1 also get rtol 1e-4: in float32,
sqrt(1 + 4 eps y) - 1 cancels, by a factor ~1 / (2 eps (y + 1)) = 250 at
y = 1, and the square doubles the relative error, so a 1-ULP difference in
how the two libraries round the inner sum reaches ~500 ULP (6e-5) of the
output there (observed 2.6e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muzero_general_tpu.games import cartpole as jax_cartpole
from muzero_general_tpu.ops import support as jax_support
from muzero_general_tpu_torch import config as torch_config
from muzero_general_tpu_torch.games import cartpole as torch_cartpole
from muzero_general_tpu_torch.ops import support as torch_support

ATOL = 1e-6
RTOL_H_INV = 1e-4  # conditioning of h^-1, see the module docstring


def _close(got, want, atol=ATOL, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("fn", ["contract_scale", "expand_scale"])
def test_scale_transforms_match_jax(fn):
    x = np.random.default_rng(0).normal(scale=30.0, size=(257,)).astype(np.float32)
    x[:4] = [0.0, -1.0, 1.0, 1e-7]
    rtol = RTOL_H_INV if fn == "expand_scale" else 1e-6
    _close(getattr(torch_support, fn)(torch.from_numpy(x)),
           getattr(jax_support, fn)(jnp.asarray(x)), rtol=rtol)


@pytest.mark.parametrize("support_size", [1, 10, 300])
def test_support_to_scalar_matches_jax(support_size):
    rng = np.random.default_rng(support_size)
    logits = rng.normal(scale=3.0, size=(16, 2 * support_size + 1)).astype(np.float32)
    got = torch_support.support_to_scalar(torch.from_numpy(logits), support_size)
    want = jax_support.support_to_scalar(jnp.asarray(logits), support_size)
    _close(got, want, rtol=RTOL_H_INV)


@pytest.mark.parametrize("support_size", [1, 10, 300])
def test_scalar_to_support_matches_jax(support_size):
    rng = np.random.default_rng(100 + support_size)
    x = rng.normal(scale=50.0, size=(64,)).astype(np.float32)
    x[:3] = [0.0, 1e6, -1e6]  # clamped at both ends of the support
    got = torch_support.scalar_to_support(torch.from_numpy(x), support_size)
    want = jax_support.scalar_to_support(jnp.asarray(x), support_size)
    _close(got, want)


def test_cartpole_config_matches_jax_attribute_for_attribute():
    want = vars(jax_cartpole.MuZeroConfig())
    got = vars(torch_cartpole.MuZeroConfig())
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == value, key


def test_apply_overrides_rejects_unknown_keys():
    cfg = torch_cartpole.MuZeroConfig()
    torch_config.apply_overrides(cfg, {"num_simulations": 7, "use_fused_search": True})
    assert cfg.num_simulations == 7 and cfg.use_fused_search is True
    with pytest.raises(AttributeError, match="no attribute"):
        torch_config.apply_overrides(cfg, {"num_simulation": 7})
    assert torch_config.load_game_module("cartpole") is torch_cartpole
