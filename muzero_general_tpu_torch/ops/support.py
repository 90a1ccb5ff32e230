"""Categorical value/reward support codecs (port of ops/support.py).

Scalars are encoded as categorical distributions over the integer support
[-support_size, support_size] after contracting the scale with
h(x) = sign(x)(sqrt(|x|+1) - 1) + eps*x (https://arxiv.org/abs/1805.11593).
Parity with reference models.py:645-689, over the last axis.
"""

import torch
import torch.nn.functional as F

EPS = 0.001


def contract_scale(x: torch.Tensor) -> torch.Tensor:
    """h(x) = sign(x)(sqrt(|x|+1)-1) + eps*x (reference models.py:675)."""
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + EPS * x


def expand_scale(x: torch.Tensor) -> torch.Tensor:
    """h^{-1}(x), the closed-form inverse (reference models.py:661-665)."""
    return torch.sign(x) * (
        torch.square(
            (torch.sqrt(1.0 + 4.0 * EPS * (torch.abs(x) + 1.0 + EPS)) - 1.0)
            / (2.0 * EPS)
        )
        - 1.0
    )


def support_to_scalar(logits: torch.Tensor, support_size: int) -> torch.Tensor:
    """Decode logits [..., 2S+1] to scalars [...]: softmax, expectation, h^-1."""
    probs = torch.softmax(logits, dim=-1)
    support = torch.arange(
        -support_size, support_size + 1, dtype=probs.dtype, device=probs.device
    )
    x = torch.sum(probs * support, dim=-1)
    return expand_scale(x)


def scalar_to_support(x: torch.Tensor, support_size: int) -> torch.Tensor:
    """Encode scalars [...] as two-hot targets [..., 2S+1].

    Apply h, clamp to the support, split mass between floor and floor+1, with
    the reference's overflow rule (models.py:685-688): mass past the top bin
    is dropped and its write redirected to bin 0.
    """
    x = contract_scale(x)
    x = torch.clamp(x, -support_size, support_size)
    floor = torch.floor(x)
    prob = x - floor
    idx_low = (floor + support_size).long()
    idx_high = idx_low + 1
    n_bins = 2 * support_size + 1
    overflow = idx_high > n_bins - 1
    prob = torch.where(overflow, torch.zeros_like(prob), prob)
    idx_high = torch.where(overflow, torch.zeros_like(idx_high), idx_high)
    low = F.one_hot(idx_low, n_bins).to(x.dtype) * (1.0 - prob)[..., None]
    high = F.one_hot(idx_high, n_bins).to(x.dtype) * prob[..., None]
    return low + high
