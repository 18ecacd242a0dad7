"""JAX's threefry random numbers in plain PyTorch (the keys of the port's
stochastic steps and dropout).

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words of a
JAX ``uint32[2]`` key (``jax.random.PRNGKey``), on the device that draws
with it.  :func:`split`, :func:`random_bits`, :func:`uniform` and
:func:`bernoulli` compute exactly what ``jax.random``'s functions of the
same names compute with the default threefry2x32 implementation and the
partitionable bit layout (``jax_threefry_partitionable``, the default
since jax 0.5): the same keys and the same bits, on the CPU and on the
card.  Everything is elementwise integer arithmetic on tensors, with no
generator state and no host read, so a step that draws from a key it
carries can be captured in a CUDA graph and replayed, and a resumed run
draws what the uninterrupted one drew.

The words are kept in int64 lanes and masked to 32 bits after every add
and shift, so no operation relies on integer overflow.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
#: threefry2x32's rotations, the two groups of four rounds alternating.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: The key-schedule parity constant of threefry (Salmon et al., 2011).
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def PRNGKey(seed: int, *, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``[seed >> 32, seed &
    0xFFFFFFFF]`` of a non-negative seed below 2**64."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64,
                        device=device)


def as_key(words, *, device=None) -> torch.Tensor:
    """A key from its uint32 words (a JAX key's ``np.asarray``, or a
    key tensor), as the int64 tensor the functions here take."""
    if torch.is_tensor(words):
        return words.to(device=device, dtype=torch.int64)
    arr = np.asarray(words)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"a key has 2 words on its last axis, got "
                         f"{arr.shape}")
    return torch.from_numpy(arr.astype(np.uint32).astype(np.int64)).to(device)


def key_data(key: torch.Tensor) -> np.ndarray:
    """The key's words as a numpy uint32 array (what ``jax.random``
    takes)."""
    return key.detach().cpu().numpy().astype(np.uint32)


def _rounds(x1: torch.Tensor, x2: torch.Tensor, rotations) -> None:
    """Four threefry rounds, in place on the two word tensors."""
    for r in rotations:
        x1.add_(x2).bitwise_and_(_MASK)
        low = x2 >> (32 - r)
        x2.bitwise_left_shift_(r).bitwise_and_(_MASK).bitwise_or_(low)
        x2.bitwise_xor_(x1)


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block cipher of ``(x1, x2)`` under the key
    ``(k1, k2)``: 20 rounds with a key injection after every four, as
    ``jax._src.prng.threefry2x32``.  Arguments broadcast; each is an int64
    tensor of uint32 values.  Returns the two output words."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    shape = torch.broadcast_shapes(k1.shape, x1.shape, x2.shape)
    x1 = (x1 + k1).bitwise_and_(_MASK).expand(shape).contiguous()
    x2 = (x2 + k2).bitwise_and_(_MASK).expand(shape).contiguous()
    for i in range(5):
        _rounds(x1, x2, _ROTATIONS[i % 2])
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x2.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_MASK)
    return x1, x2


def _counts(shape, device):
    """``iota_2x32_shape``: the row-major index of every element of
    ``shape`` as (high, low) 32-bit words."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(d) for d in shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``num`` new keys ``[..., num, 2]``
    from each key of ``key [..., 2]`` (a batch of keys splits each, as
    ``jax.vmap(jax.random.split)``)."""
    hi, lo = _counts((num,), key.device)
    bits1, bits2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack([bits1, bits2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: 32 random bits an
    element, as int64 values."""
    hi, lo = _counts(_shape(shape), key.device)
    bits1, bits2 = threefry2x32(key[0], key[1], hi, lo)
    return bits1.bitwise_xor_(bits2)


def uniform(key: torch.Tensor, shape: Shape,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) for f32: the top 23
    bits as the mantissa of a float in [1, 2), minus one."""
    if dtype != torch.float32:
        raise NotImplementedError(
            f"uniform draws float32 only (JAX's layout for {dtype} has no "
            f"port yet), got {dtype}")
    bits = random_bits(key, shape)
    bits = bits.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape: Shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    ``uniform(key, shape) < float32(p)``, a bool tensor."""
    u = uniform(key, shape)
    return u < torch.full((), p, dtype=torch.float32, device=u.device)
