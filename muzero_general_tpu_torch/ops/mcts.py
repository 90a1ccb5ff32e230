"""Search helpers shared by the search paths (port of parts of ops/mcts.py).

Only what the fused search path uses is ported so far: the masked root
softmax, the root Dirichlet noise, temperature action selection and the
visit policy. The staged search (`run_mcts`) is ROADMAP module item 6.
"""

import math
from typing import Optional

import torch


def masked_softmax(logits, mask):
    """Softmax over masked entries; masked-out entries get exactly 0."""
    neg = torch.finfo(logits.dtype).min
    z = torch.where(mask, logits, neg)
    z = z - torch.amax(z, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(z), 0.0)
    return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-30)


def sample_gamma(alpha: float, shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Gamma(alpha, 1) draws from an explicit generator.

    torch's own gamma sampler takes no generator, so this is Marsaglia and
    Tsang's method (ACM TOMS 26(3), 2000) on torch.randn/torch.rand: rejection
    rounds until every entry is accepted, and for alpha < 1 a Gamma(alpha+1)
    draw times U^(1/alpha).
    """
    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, device=device)
    pending = torch.ones(shape, dtype=torch.bool, device=device)
    while True:
        x = torch.randn(shape, generator=generator, device=device)
        u = torch.rand(shape, generator=generator, device=device)
        v = (1.0 + c * x) ** 3
        log_v = torch.log(torch.clamp(v, min=1e-30))
        accept = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
        take = pending & accept
        out = torch.where(take, d * v, out)
        pending = pending & ~accept
        if not bool(pending.any()):
            break
    if boost:
        u = torch.rand(shape, generator=generator, device=device)
        out = out * torch.exp(torch.log(u) / alpha)
    return out


def add_root_noise(prior, legal_mask, dirichlet_alpha: float,
                   exploration_fraction: float,
                   generator: Optional[torch.Generator] = None,
                   root_noise: Optional[torch.Tensor] = None):
    """Mix Dirichlet noise into the legal root prior (reference
    self_play.py:467-476; JAX ops/mcts.py:1040-1049).

    Dirichlet over the legal subset == normalized masked Gamma draws. The
    Gammas [B, A] are drawn from `generator`, or taken from `root_noise`
    (tests inject the JAX side's own draw).
    """
    if root_noise is None:
        root_noise = sample_gamma(dirichlet_alpha, tuple(prior.shape), generator,
                                  prior.device)
    g = torch.where(legal_mask, root_noise.to(prior.dtype), 0.0)
    noise = g / torch.clamp(torch.sum(g, dim=-1, keepdim=True), min=1e-30)
    frac = exploration_fraction
    return torch.where(legal_mask, prior * (1 - frac) + noise * frac, 0.0)


def select_action(generator, visit_counts, legal_mask, temperature):
    """Sample an action from root visit counts with temperature.

    Parity: reference self_play.py:222-245 (JAX ops/mcts.py:1207-1236):
    T=0 -> argmax, T=inf -> uniform over legal actions, else visits^(1/T).
    `temperature` is a float or a per-lane [B] tensor. The draw is the
    Gumbel-max form of a categorical sample, as jax.random.categorical.
    """
    visits = visit_counts.to(torch.float32)
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=visits.device)
    if temperature.dim() == visits.dim() - 1:
        temperature = temperature[..., None]  # [B] -> [B, 1] broadcast
    t_safe = torch.where(
        (temperature <= 0) | ~torch.isfinite(temperature), 1.0, temperature
    )
    powed = torch.where(legal_mask, visits ** (1.0 / t_safe), 0.0)
    powed = powed / torch.clamp(torch.sum(powed, dim=-1, keepdim=True), min=1e-30)
    uniform = legal_mask.to(torch.float32)
    uniform = uniform / torch.clamp(torch.sum(uniform, dim=-1, keepdim=True),
                                    min=1e-30)
    greedy = torch.nn.functional.one_hot(
        torch.argmax(torch.where(legal_mask, visits, -1.0), dim=-1),
        visits.shape[-1],
    ).to(torch.float32)
    probs = torch.where(
        temperature == 0,
        greedy,
        torch.where(torch.isinf(temperature), uniform, powed),
    )
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(torch.log(probs + 1e-30) + gumbel, dim=-1)


def visit_policy(visit_counts):
    """Normalized visit distribution over the full action space
    (reference GameHistory.store_search_statistics, self_play.py:496-509)."""
    v = visit_counts.to(torch.float32)
    return v / torch.clamp(torch.sum(v, dim=-1, keepdim=True), min=1e-30)
