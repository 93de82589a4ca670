"""(vobench's frozen copy: the wrapper below runs the plain version on every
device; the CUDA kernel is not launched.)

svo_tpu's PRNG: threefry-2x32 keys, split and Gumbel noise.

The port's counterpart of what svo_tpu takes from jax.random, so the port
draws svo_tpu's PnP noise exactly (up to the rounding of log) and keeps its
key in the state as svo_tpu does. The spec is jax's default PRNG (jax
0.9, jax_threefry_partitionable on, 32-bit mode; jax/_src/prng.py):

- prng_key(seed) is threefry_seed: (0, seed mod 2**32), since a Python
  int seed is cut to 32 bits before it is split into two words;
- threefry2x32 is _threefry2x32_lowering: Threefry-2x32, 20 rounds;
- split(key) is _threefry_split_foldlike for two keys: (hash(key, (0, 0)),
  hash(key, (0, 1))); svo_tpu's frame step keeps the first and samples
  with the second;
- random_bits(key, shape) is _threefry_random_bits_partitionable for 32
  bits: hi ^ lo of hash(key, (0, i)) for flat index i;
- gumbel(key, shape) is jax/_src/random.py::_gumbel in mode "low":
  -log(-log(uniform(minval=tiny, maxval=1))), the uniform made from the
  bits as jax.random.uniform makes it.

Keys are int32 tensors holding the uint32 bits, (2,) for one stream or
(S, 2) for S streams (torch's uint32 has few ops); every function takes
that leading stream axis, key s giving what jax gives for key s alone.
The plain versions compute in int64 with & 0xFFFFFFFF.

split_gumbel(keys, shape) is the frame step's draw: the new keys and the
(S, *shape) Gumbel noise. On a CUDA tensor it launches the hand-written
kernel csrc/threefry.cu, once for all S streams; on a CPU tensor it runs
the plain version (the CPU tests' path, and what chip_smoke.py holds the
kernel against on the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _u32(keys: torch.Tensor) -> torch.Tensor:
    """int32 key bits -> their uint32 values in int64."""
    return keys.to(torch.int64) & _M32


def _i32(v: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 -> the same bits as int32."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int32 or keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(
            f"keys must be int32 (2,) or (S, 2) tensors of uint32 bits, got "
            f"{keys.dtype} {tuple(keys.shape)}"
        )


def threefry2x32_ref(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of the counters (x0, x1) under the key
    (k0, k1): int64 tensors of uint32 values that broadcast together.
    Returns the two hashed words, int64 in [0, 2**32)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for an int seed -> (2,); a sequence, array
    or tensor of S seeds -> (S, 2), key s = prng_key(seed[s]) (svo_tpu's
    vmapped bootstrap)."""
    if isinstance(seed, torch.Tensor):
        s = seed.to(device=device, dtype=torch.int64)
    else:
        s = torch.as_tensor(np.asarray(seed).astype(np.int64), device=device)
    s = s & _M32
    return _i32(torch.stack([torch.zeros_like(s), s], dim=-1))


def split(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.random.split(key) unpacked as svo_tpu's frame step does,
    `rng, sub = split(key)`: (the key the state keeps, the key it samples
    with), each of the keys' shape."""
    _check_keys(keys)
    k0, k1 = _u32(keys).unbind(-1)
    zero = torch.zeros_like(k0)
    rng = threefry2x32_ref(k0, k1, zero, zero)
    sub = threefry2x32_ref(k0, k1, zero, zero + 1)
    return _i32(torch.stack(rng, dim=-1)), _i32(torch.stack(sub, dim=-1))


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.bits(key, shape) (uint32) as int64 values, with the keys'
    leading axes in front: (*keys.shape[:-1], *shape)."""
    _check_keys(keys)
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError(f"{n} values do not fit the 32-bit counter")
    k0, k1 = (k[..., None] for k in _u32(keys).unbind(-1))
    ctr = torch.arange(n, dtype=torch.int64, device=keys.device)
    x0, x1 = threefry2x32_ref(k0, k1, torch.zeros_like(ctr), ctr)
    return (x0 ^ x1).reshape(keys.shape[:-1] + shape)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel float32 from 32-bit words (int64 values), as
    jax.random.gumbel(mode="low") makes it from its uniform bits."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    # jax.random.uniform(minval=tiny, maxval=1): floats * (1 - tiny) + tiny,
    # max'ed with tiny (1 - tiny rounds to 1 in float32)
    u = torch.clamp_min(floats * 1.0 + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.gumbel(key, shape) (float32, mode "low") with the keys'
    leading axes in front."""
    return gumbel_from_bits(random_bits(keys, shape))


def split_gumbel_ref(keys: torch.Tensor, shape, with_bits: bool = False):
    """Plain PyTorch version of split_gumbel."""
    rng, sub = split(keys)
    bits = random_bits(sub, shape)
    noise = gumbel_from_bits(bits)
    return (rng, noise, bits) if with_bits else (rng, noise)


def split_gumbel(keys: torch.Tensor, shape, with_bits: bool = False):
    """svo_tpu's frame-step draw, `rng, sub = split(key)` then
    `gumbel(sub, shape)`: keys (2,) or (S, 2) int32 -> (new keys of the
    same shape, (*keys.shape[:-1], *shape) float32 noise). One kernel launch
    for all streams on a CUDA tensor, the plain version on a CPU tensor.
    with_bits=True also returns the 32-bit words the noise was made from
    (int64 values, random_bits' form), to check the kernel by."""
    _check_keys(keys)
    return split_gumbel_ref(keys, shape, with_bits)

