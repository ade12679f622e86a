"""JAX's threefry2x32 random numbers, for the flow noise of a control step.

The JAX package draws each request's flow noise as
``jax.random.normal(fold_in(PRNGKey(seed), request_idx), shape, dtype)``
(``blurr_tpu/agent/eval_agent.py:make_noise_infer``, shared by the serial
agent, batched eval, open-loop eval and the action server). This module
computes the same numbers with numpy and torch, so the port serves the same
noise for the same seed and request index:

- ``prng_key``, ``fold_in``, ``split``, ``threefry2x32`` and ``random_bits`` follow
  JAX's default implementation (``jax_default_prng_impl = threefry2x32``)
  with ``jax_threefry_partitionable`` on, the default since JAX 0.5: the
  counter of element i of the flattened shape is the 64-bit i split into
  (high, low) 32-bit words, and the bits are the xor of the two hash
  outputs (``jax/_src/prng.py:_threefry_random_bits_partitionable``). The
  uint32 arithmetic runs in numpy on the host, where it wraps exactly.
- ``normal`` follows ``jax/_src/random.py:_normal_real``: a uniform in
  [nextafter(-1, 0), 1) built from the top mantissa bits of a draw of
  random bits (32 bits for fp32; 8 for bf16, whose mantissa has 7: a bf16
  normal is not the fp32 normal rounded, and takes one of 128 values),
  then ``sqrt(2) * erf_inv(u)`` in ``dtype``. ``erf_inv`` is XLA's
  polynomial, not ``torch.erfinv``. The map runs in torch on the CPU and
  the few values then move to the device, so the noise does not depend on
  the device. The bf16 noise equals JAX's bit for bit; the fp32 noise is
  within 4 ulps of it (``tests/test_torch_prng.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_UINT = {8: np.uint8, 16: np.uint16, 32: np.uint32}
# per float type: its width, its mantissa bits, and the random bits JAX
# draws for it (its width, but 8 where the mantissa has fewer than 8 bits)
_FLOATS = {torch.float32: (32, 23, 32), torch.bfloat16: (16, 7, 8)}


def prng_key(seed: int) -> np.ndarray:
    """The key data of ``jax.random.PRNGKey(seed)``: uint32 [2]. Without
    x64, JAX keeps the seed's low 32 bits and a zero high word."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counters (x0, x1) under
    ``key``, elementwise: two uint32 arrays of x0's shape."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = np.asarray(x0, np.uint32) + ks[0]
    b = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = _rotl(b, r) ^ a
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def fold_in(key, data: int) -> np.ndarray:
    """The key data of ``jax.random.fold_in(key, data)``: the hash of the
    counter (0, data) under ``key``."""
    a, b = threefry2x32(key, np.zeros(1, np.uint32),
                        np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.concatenate([a, b])


def split(key, num: int = 2) -> np.ndarray:
    """The key data of ``jax.random.split(key, num)``: uint32 [num, 2]. With
    ``jax_threefry_partitionable`` on, key i is the hash of the counter
    (0, i) under ``key`` (``jax/_src/prng.py:_threefry_split_foldlike``)."""
    a, b = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([a, b], axis=1)


def random_bits(key, shape, bit_width: int = 32) -> np.ndarray:
    """``jax.random.bits(key, shape)`` at 8, 16 or 32 bits: the low bits of
    the 32-bit draw, as uint8, uint16 or uint32 of ``shape``."""
    if bit_width not in _UINT:
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    a, b = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                        idx.astype(np.uint32))
    return (a ^ b).reshape(shape).astype(_UINT[bit_width])


def normal(key, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` as a tensor on ``device``
    (float32 or bfloat16)."""
    if dtype not in _FLOATS:
        raise ValueError(f"normal draws float32 or bfloat16, not {dtype}")
    nbits, nmant, rng_bits = _FLOATS[dtype]
    bits = random_bits(key, tuple(shape), rng_bits).astype(_UINT[nbits])
    one = torch.tensor(1.0, dtype=dtype)
    signed = torch.int32 if nbits == 32 else torch.int16
    one_bits = np.array(int(one.view(signed)), _UINT[nbits])
    mant = (bits >> (rng_bits - nmant)) | one_bits  # [1, 2) in dtype
    floats = torch.from_numpy(mant.view(np.int32 if nbits == 32 else np.int16))
    floats = floats.view(dtype) - one  # [0, 1)
    lo = torch.nextafter(-one, torch.zeros((), dtype=dtype))
    u = torch.maximum(lo, floats * (one - lo) + lo)
    z = erf_inv(u.float()).to(dtype)
    return (torch.tensor(math.sqrt(2), dtype=dtype) * z).to(device)


# Giles' single-precision erfinv, "Approximating the erfinv function" (2010),
# as XLA expands erf_inv for fp32 (and for bf16, through fp32)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's fp32 erf_inv: Giles' polynomial in w = -log1p(-x^2), each step
    a fused multiply-add (the product exact in float64, then rounded to
    fp32). ``torch.erfinv`` is accurate to ~1 ulp, XLA's polynomial only to
    ~60 ulps near |x| = 1; this follows XLA to within 2 ulps (torch's log1p
    and XLA's differ by an ulp)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    lt_c, ge_c = (torch.tensor(c, dtype=torch.float32) for c in (_ERFINV_W_LT_5, _ERFINV_W_GE_5))
    coef = torch.where(lt[..., None], lt_c, ge_c).double()
    p = coef[..., 0]
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = (coef[..., i] + p * w).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1, x * math.inf, out)
