"""The JAX package's random streams in PyTorch: jax.random's Threefry-2x32
keys, splits, fold-ins and its uniform and normal draws, bit for bit.

The JAX package draws every random number with jax.random (JAX 0.9 with
`jax_threefry_partitionable` on, its default): the white noise of the
initial conditions, the uniform and glass loads, `random_state`, the
light cone's tile shifts. This module computes the same numbers from the
same keys, so a config run by the port is the realisation the JAX package
runs:

  * keys are [2] torch.uint32 tensors on the host (`PRNGKey(seed)` is
    [0, seed & 0xFFFFFFFF], as JAX makes it without 64-bit mode); a key
    from the JAX package, passed as a numpy array, works as well;
  * `split` and `fold_in` hash on the host; `random_bits`, `uniform` and
    `normal` hash on `device`, the card unless the caller names another,
    in int64 arithmetic masked to 32 bits (so a 216^3 noise field is
    drawn on the card);
  * `uniform` is bit-equal to jax.random.uniform; `normal` applies XLA's
    float32 erf_inv polynomial (Giles) to the uniform on
    [nextafter(-1, 0), 1), as jax.random.normal does. Its log1p is
    computed here in float64 from correctly rounded operations only (its
    sqrt too), so a draw gives the same bits on the CPU and on the card;
    against JAX it differs where XLA's float32 log1p rounds otherwise (a
    few ulp).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"):
# Horner coefficients in w - 2.5 for w < 5, else in sqrt(w) - 3
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_LN2 = math.log(2.0)
_SQRT_HALF = math.sqrt(0.5)


def PRNGKey(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey(seed): the key [0, seed] as two uint32 words
    (the seed taken modulo 2^32, as JAX takes it without 64-bit mode)."""
    return _key(0, int(seed) & _M32)


def _key(k1: int, k2: int) -> torch.Tensor:
    return torch.tensor([k1, k2], dtype=torch.int64).to(torch.uint32)


def _words(key) -> tuple[int, int]:
    """(k1, k2) of a key: a [2] tensor or array of uint32 words."""
    if isinstance(key, torch.Tensor):
        key = key.detach().to("cpu", torch.int64).numpy()
    words = np.asarray(key).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"a PRNG key is two uint32 words, got shape "
                         f"{np.asarray(key).shape}")
    return int(words[0]) & _M32, int(words[1]) & _M32


def is_key(x) -> bool:
    """True for a key: a [2] uint32 torch tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.uint32 and tuple(x.shape) == (2,)
    return (isinstance(x, np.ndarray) and x.dtype == np.uint32
            and x.shape == (2,))


def threefry2x32(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key (k1, k2); int64 tensors holding uint32 values in, the
    two uint32 output words out."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1.add_(x2).bitwise_and_(_M32)
            x2 = ((x2 << r).bitwise_or_(x2 >> (32 - r))
                  ).bitwise_and_(_M32).bitwise_xor_(x1)
        x1 = x1.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x2 = x2.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x1, x2


def _counter(n: int, device):
    """The (hi, lo) words of the flat indices 0..n-1 (JAX's
    iota_2x32_shape)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _M32


def split(key, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): [num, 2] uint32 keys (the fold-like
    split of the partitionable scheme)."""
    k1, k2 = _words(key)
    b1, b2 = threefry2x32(k1, k2, *_counter(int(num), "cpu"))
    return torch.stack([b1, b2], dim=1).to(torch.uint32)


def fold_in(key, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data): the hash of the counter [0, data]."""
    k1, k2 = _words(key)
    b1, b2 = threefry2x32(k1, k2, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _M32]))
    return _key(int(b1[0]), int(b2[0]))


def random_bits(key, shape, device="cuda") -> torch.Tensor:
    """32 random bits per element (int64 holding uint32 values) on
    `device`: the partitionable scheme, the counter the (hi, lo) words of
    each element's flat index and the bits the two output words' xor."""
    shape = tuple(int(s) for s in shape)
    k1, k2 = _words(key)
    b1, b2 = threefry2x32(k1, k2, *_counter(math.prod(shape), device))
    return b1.bitwise_xor_(b2).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0, device="cuda"
            ) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval) on
    `device`: 23 random mantissa bits OR'd into 1.0, minus 1, scaled to
    [minval, maxval) and clamped below at minval."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, _fma(floats - 1.0, hi - lo, lo))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c for float32 tensors, rounded once to float32, as XLA
    contracts a multiply and an add: the product is exact in float64,
    the sum is rounded to odd there (its error from TwoSum), and that
    rounds to float32 as the exact value would."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def _log1p(y: torch.Tensor) -> torch.Tensor:
    """log1p of a float32 tensor in (-1, 0], rounded to float32, from
    float64 operations that round correctly on every device: u = 1 + y,
    log(u) by its exponent and 2 atanh(s) of the mantissa, and the
    factor y / (u - 1) that corrects u's rounding."""
    yd = y.to(torch.float64)
    u = 1.0 + yd
    bits = u.view(torch.int64)
    e = ((bits >> 52) & 0x7FF) - 1022
    m = ((bits & 0x000FFFFFFFFFFFFF) | (1022 << 52)).view(torch.float64)
    low = m < _SQRT_HALF
    m = torch.where(low, m + m, m)
    e = (e - low.to(torch.int64)).to(torch.float64)
    f = m - 1.0
    s = f / (f + 2.0)
    s2 = s * s
    p = torch.full_like(s, 1.0 / 25.0)
    for k in range(11, -1, -1):
        p = p * s2 + 1.0 / (2 * k + 1)
    log_u = e * _LN2 + (s + s) * p
    den = u - 1.0
    out = torch.where(den == 0.0, yd,
                      log_u * (yd / torch.where(den == 0.0, 1.0, den)))
    return out.to(torch.float32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv of x in (-1, 1): w = -log1p(-x^2), a 9-term
    Horner polynomial in w - 2.5 for w < 5, else in sqrt(w) - 3, each step
    a fused multiply-add as XLA compiles it, times x (+-inf at +-1)."""
    w = -_log1p(x * -x)
    small = w < 5.0
    # sqrt in float64, rounded once to float32: the correctly rounded
    # float32 sqrt (PyTorch's CUDA float32 sqrt is not)
    root = torch.sqrt(w.to(torch.float64)).to(torch.float32)
    t = torch.where(small, w - 2.5, root - 3.0)
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, t, torch.where(small, cs, cl))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key, shape, device="cuda") -> torch.Tensor:
    """jax.random.normal(key, shape, float32) on `device`: sqrt(2) times
    XLA's erf_inv of a uniform on [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return erf_inv(u) * float(np.float32(math.sqrt(2.0)))
