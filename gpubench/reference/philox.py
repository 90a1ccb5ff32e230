"""Philox4x32-10 (Salmon et al., SC'11) in int64 torch ops: the tie-jitter
stream of the search's descent, keyed by a seed, with counter (lane,
simulation, level, action // 4); action a takes word a % 4 of its block.
A frozen copy of the stream the program's descent kernel draws, so the
reference breaks exact pUCT ties the same way."""

import torch

TIE_JITTER = 1e-5
U32_RANGE = 4.2949673e9  # jitter scale divisor
_MASK32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
_W = (0x9E3779B9, 0xBB67AE85)  # key increments (Weyl sequence)


def _mulhilo32(m: int, x):
    """(high, low) 32-bit words of m * x for uint32 values held in int64;
    16-bit limbs keep every product below 2^63."""
    p_lo = (x & 0xFFFF) * m
    mid = (x >> 16) * m + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(counter, key: int):
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_M[0], c0)
        hi1, lo1 = _mulhilo32(_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W[0]) & _MASK32
        k1 = (k1 + _W[1]) & _MASK32
    return c0, c1, c2, c3


def jitter_bits(B, A, sim, levels, key, dev):
    """The tie-jitter bits [B, levels, A] (int64 in [0, 2^32)) of one
    simulation."""
    lane = torch.arange(B, dtype=torch.int64, device=dev)[:, None, None]
    level = torch.arange(levels, dtype=torch.int64, device=dev)[None, :, None]
    group = torch.arange((A + 3) // 4, dtype=torch.int64, device=dev)[None, None, :]
    words = philox4x32_10((lane, torch.tensor(sim, device=dev), level, group), key)
    return torch.stack(words, -1).reshape(B, levels, -1)[:, :, :A]
