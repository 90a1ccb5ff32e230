"""Philox4x32-10 tie jitter shared by the search kernels' plain versions.

The JAX package's TPU kernels break exact pUCT ties by adding
bits * tie_jitter / 2^32 from the TPU's own PRNG. The port's CUDA kernels
draw the bits from a Philox4x32-10 stream instead (Salmon et al., SC'11),
keyed by a seed the wrapper passes, with counter (lane, simulation, level,
action // 4): action a takes word a % 4 of its block. The functions here
compute the same stream in int64 torch ops, so a kernel and its plain
version are compared exactly with the jitter on.
"""

import torch

TIE_JITTER = 1e-5
U32_RANGE = 4.2949673e9  # jitter scale divisor, as in the JAX kernels
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # round multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # key increments (Weyl sequence)


def _mulhilo32(m: int, x):
    """(high, low) 32-bit words of m * x, for a uint32 constant m and uint32
    values x held in int64: 16-bit limbs keep every product below 2^63."""
    p_lo = (x & 0xFFFF) * m
    mid = (x >> 16) * m + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(counter, key: int):
    """Philox4x32-10, as the CUDA kernels compute it.

    counter: four int64 tensors of uint32 words (broadcastable); key: the
    64-bit seed, low word first. Returns the four output words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def jitter_bits(B, A, sim, levels, key, dev):
    """The kernels' tie-jitter bits [B, levels, A] (int64 in [0, 2^32)) of
    one simulation: action a at a level takes word a % 4 of the Philox
    block at counter (lane, simulation, level, a // 4)."""
    lane = torch.arange(B, dtype=torch.int64, device=dev)[:, None, None]
    level = torch.arange(levels, dtype=torch.int64, device=dev)[None, :, None]
    group = torch.arange((A + 3) // 4, dtype=torch.int64, device=dev)[None, None, :]
    words = philox4x32_10((lane, torch.tensor(sim, device=dev), level, group), key)
    return torch.stack(words, -1).reshape(B, levels, -1)[:, :, :A]
