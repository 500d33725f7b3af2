"""Quasi-random sequences and antithetic normals, in torch.

The port of ``optionslab_tpu/ops/rng.py``. Where the JAX version takes a
``jax.random`` key, these functions take an explicit ``torch.Generator``;
the Sobol direction numbers are the port's own copy of the Joe–Kuo table
(numpy only), so :func:`_direction_matrix` is bit-equal to the reference's.

* :func:`sobol_sequence` — Gray-code Sobol points, optionally digitally
  shifted (random digit scrambling that preserves the net);
* :func:`halton_sequence` — randomly shifted Halton points for more
  dimensions than the table has;
* :func:`qmc_normals` — either, through the inverse normal CDF;
* :func:`antithetic_normals` — n normals whose second half mirrors the first.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .math import norm_ppf

# First 64 dimensions of the Joe–Kuo D6 table as (s, a, [m_1..m_s]);
# dimension 0 (van der Corput) is implicit. Public table data (Joe & Kuo 2008).
_JOE_KUO = [
    (1, 0, [1]),
    (2, 1, [1, 3]),
    (3, 1, [1, 3, 1]),
    (3, 2, [1, 1, 1]),
    (4, 1, [1, 1, 3, 3]),
    (4, 4, [1, 3, 5, 13]),
    (5, 2, [1, 1, 5, 5, 17]),
    (5, 4, [1, 1, 5, 5, 5]),
    (5, 7, [1, 1, 7, 11, 19]),
    (5, 11, [1, 1, 5, 1, 1]),
    (5, 13, [1, 1, 1, 3, 11]),
    (5, 14, [1, 3, 5, 5, 31]),
    (6, 1, [1, 3, 3, 9, 7, 49]),
    (6, 13, [1, 1, 1, 15, 21, 21]),
    (6, 16, [1, 3, 1, 13, 27, 49]),
    (6, 19, [1, 1, 1, 15, 7, 5]),
    (6, 22, [1, 3, 1, 15, 13, 25]),
    (6, 25, [1, 1, 5, 5, 19, 61]),
    (7, 1, [1, 3, 7, 11, 23, 15, 103]),
    (7, 4, [1, 3, 7, 13, 13, 15, 69]),
    (7, 7, [1, 1, 3, 13, 7, 35, 63]),
    (7, 8, [1, 3, 5, 9, 1, 25, 53]),
    (7, 14, [1, 3, 1, 13, 9, 35, 107]),
    (7, 19, [1, 3, 1, 5, 27, 61, 31]),
    (7, 21, [1, 1, 5, 11, 19, 41, 61]),
    (7, 28, [1, 3, 5, 3, 3, 13, 69]),
    (7, 31, [1, 1, 7, 13, 1, 19, 1]),
    (7, 32, [1, 3, 7, 5, 13, 19, 59]),
    (7, 37, [1, 1, 3, 9, 25, 29, 41]),
    (7, 41, [1, 3, 5, 13, 23, 1, 55]),
    (7, 42, [1, 3, 7, 3, 13, 59, 17]),
    (7, 50, [1, 3, 1, 3, 5, 53, 69]),
    (7, 55, [1, 1, 5, 5, 23, 33, 13]),
    (7, 56, [1, 1, 7, 7, 1, 61, 123]),
    (7, 59, [1, 1, 7, 9, 13, 61, 49]),
    (7, 62, [1, 3, 3, 5, 3, 55, 33]),
    (8, 14, [1, 3, 1, 15, 31, 13, 49, 245]),
    (8, 21, [1, 3, 5, 15, 31, 59, 76, 125]),
    (8, 22, [1, 1, 7, 11, 11, 29, 51, 97]),
    (8, 38, [1, 3, 3, 13, 19, 23, 45, 41]),
    (8, 47, [1, 1, 3, 5, 13, 21, 69, 45]),
    (8, 49, [1, 3, 7, 15, 19, 49, 23, 95]),
    (8, 50, [1, 3, 7, 13, 9, 25, 23, 11]),
    (8, 52, [1, 1, 3, 13, 13, 11, 109, 63]),
    (8, 56, [1, 3, 7, 9, 21, 37, 5, 107]),
    (8, 67, [1, 1, 1, 1, 21, 33, 27, 35]),
    (8, 70, [1, 1, 1, 9, 5, 43, 87, 205]),
    (8, 84, [1, 1, 5, 5, 5, 43, 113, 187]),
    (8, 97, [1, 3, 3, 5, 17, 29, 59, 103]),
    (8, 103, [1, 1, 7, 3, 25, 17, 53, 179]),
    (8, 115, [1, 3, 1, 1, 9, 23, 57, 95]),
    (8, 122, [1, 1, 1, 13, 13, 35, 119, 245]),
    (9, 8, [1, 3, 3, 9, 3, 9, 95, 11, 311]),
    (9, 13, [1, 1, 5, 3, 29, 49, 51, 205, 175]),
    (9, 16, [1, 3, 7, 3, 21, 5, 79, 61, 277]),
    (9, 22, [1, 3, 3, 3, 9, 25, 29, 157, 33]),
    (9, 25, [1, 1, 5, 15, 11, 9, 111, 221, 411]),
    (9, 44, [1, 1, 7, 11, 3, 37, 99, 233, 219]),
    (9, 47, [1, 3, 5, 9, 7, 43, 99, 77, 311]),
    (9, 52, [1, 3, 1, 11, 27, 53, 73, 67, 461]),
    (9, 55, [1, 1, 7, 15, 25, 51, 1, 65, 53]),
    (9, 59, [1, 3, 3, 1, 25, 61, 39, 27, 365]),
    (9, 62, [1, 3, 7, 5, 7, 39, 63, 197, 181]),
    (9, 67, [1, 1, 3, 7, 27, 59, 113, 153, 129]),
]

MAX_SOBOL_DIM = len(_JOE_KUO) + 1  # +1 for the van der Corput dimension 0
_SOBOL_BITS = 30


@functools.lru_cache(maxsize=1)
def _direction_matrix() -> np.ndarray:
    """(MAX_SOBOL_DIM, 30) uint32 direction numbers V[d][k]."""
    v_all = np.zeros((MAX_SOBOL_DIM, _SOBOL_BITS), dtype=np.uint32)
    for k in range(_SOBOL_BITS):
        v_all[0, k] = 1 << (_SOBOL_BITS - 1 - k)
    for d, (s, a, m) in enumerate(_JOE_KUO, start=1):
        v = [0] * _SOBOL_BITS
        for k in range(min(s, _SOBOL_BITS)):
            v[k] = m[k] << (_SOBOL_BITS - 1 - k)
        for k in range(s, _SOBOL_BITS):
            vk = v[k - s] ^ (v[k - s] >> s)
            for j in range(1, s):
                if (a >> (s - 1 - j)) & 1:
                    vk ^= v[k - j]
            v[k] = vk
        v_all[d] = np.asarray(v, dtype=np.uint64).astype(np.uint32)
    return v_all


def sobol_sequence(n: int, dim: int, *, generator: torch.Generator | None = None,
                   skip: int = 0, dtype=torch.float32, device=None) -> torch.Tensor:
    """Points ``skip+1 .. skip+n`` of the ``dim``-D Sobol sequence, (n, dim).

    Point i's integer coordinate is the XOR of the direction numbers at the
    set bits of gray(i). With ``generator`` each dimension gets a random
    30-bit digital shift (net-preserving scrambling).
    """
    if dim > MAX_SOBOL_DIM:
        raise ValueError(f"sobol_sequence supports up to {MAX_SOBOL_DIM} dims; "
                         "use halton_sequence for more")
    v = torch.as_tensor(_direction_matrix()[:dim].astype(np.int64), device=device)  # (dim, 30)
    i = torch.arange(skip + 1, skip + n + 1, dtype=torch.int64, device=device)
    gray = i ^ (i >> 1)
    x = torch.zeros((n, dim), dtype=torch.int64, device=device)
    for k in range(_SOBOL_BITS):
        x ^= ((gray >> k) & 1)[:, None] * v[None, :, k]
    if generator is not None:
        shift = torch.randint(0, 1 << _SOBOL_BITS, (dim,), generator=generator,
                              dtype=torch.int64, device=generator.device).to(x.device)
        x ^= shift[None, :]
    return (x.to(dtype) + 0.5) * (1.0 / (1 << _SOBOL_BITS))


_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
           73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149, 151,
           157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229, 233,
           239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311, 313, 317,
           331, 337, 347, 349, 353, 359, 367, 373, 379, 383, 389, 397, 401, 409, 419,
           421, 431, 433, 439, 443, 449, 457, 461, 463, 467, 479, 487, 491, 499, 503,
           509, 521, 523, 541)


def halton_sequence(n: int, dim: int, *, generator: torch.Generator | None = None,
                    skip: int = 0, dtype=torch.float32, device=None) -> torch.Tensor:
    """Randomly shifted Halton points ``skip+1 .. skip+n``, (n, dim), kept
    strictly inside (0, 1)."""
    if dim > len(_PRIMES):
        raise ValueError(f"halton_sequence supports up to {len(_PRIMES)} dims")
    work = torch.float64 if dtype == torch.float64 else torch.float32
    idx = torch.arange(skip + 1, skip + n + 1, dtype=torch.int64, device=device)
    cols = []
    for b in _PRIMES[:dim]:
        i = idx
        f = torch.zeros(n, dtype=work, device=device)
        base_inv = 1.0 / b
        for _ in range(int(math.ceil(math.log(skip + n + 1) / math.log(b))) + 1):
            f = f + (i % b).to(work) * base_inv
            i = i // b
            base_inv /= b
        cols.append(f)
    u = torch.stack(cols, dim=1).to(dtype)
    if generator is not None:
        shift = torch.rand((dim,), generator=generator, dtype=dtype,
                           device=generator.device).to(u.device)
        u = torch.remainder(u + shift[None, :], 1.0)
    return torch.clamp(u, 1e-7, 1.0 - 1e-7)


def qmc_normals(n: int, dim: int, *, generator: torch.Generator | None = None,
                engine: str = "sobol", skip: int = 0, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Low-discrepancy standard normals (n, dim) by the inverse normal CDF."""
    if engine == "sobol" and dim <= MAX_SOBOL_DIM:
        u = sobol_sequence(n, dim, generator=generator, skip=skip, dtype=dtype, device=device)
    else:
        u = halton_sequence(n, dim, generator=generator, skip=skip, dtype=dtype, device=device)
    return norm_ppf(torch.clamp(u, 2e-8, 1.0 - 2e-8)).to(dtype)


def antithetic_normals(generator: torch.Generator, n: int, *,
                       dtype=torch.float32) -> torch.Tensor:
    """n standard normals on the generator's device; the second half mirrors
    the first (n even)."""
    z = torch.randn((n // 2,), generator=generator, dtype=dtype, device=generator.device)
    return torch.cat([z, -z])
