"""FFT as dense matmuls on planar (re, im) pairs — no complex HLO.

A two-level Cooley-Tukey decomposition N = N1*N2 turns the DFT into two
small dense matmuls plus a twiddle multiply:

    A[n1, n2] = x[N2*n1 + n2]
    B = DFT_N1 @ A                      (contract n1)
    C[k1, n2] = B[k1, n2] * W_N^(k1*n2) (twiddle)
    D = C @ DFT_N2^T                    (contract n2)
    X[N1*k2 + k1] = D[k1, k2]

Each complex matmul is 4 real matmuls; the twiddles fuse into the
elementwise stream. Sizes with a factor split
whose parts are <= ``max_factor`` use this path; small/prime sizes fall
back to a single dense DFT matmul. Batched over leading dimensions.

This replaces ``jnp.fft`` everywhere in the pipeline; the FFT sizes
here (rate/10) are highly composite. Whether cuFFT through ``jnp.fft``
is faster on the GPU is ROADMAP S3.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import CF

_MAX_FACTOR = 512


@functools.lru_cache(maxsize=32)
def _dft_mats(n: int, sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin DFT matrices W[k, t] = exp(sign*2pi*i*k*t/n), host f64->f32."""
    k = np.arange(n)[:, None]
    t = np.arange(n)[None, :]
    ang = sign * 2.0 * np.pi * (k * t % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _twiddles(n1: int, n2: int, sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """W_N^(sign*k1*n2) as [n1, n2] cos/sin, host-exact."""
    n = n1 * n2
    k1 = np.arange(n1)[:, None]
    m2 = np.arange(n2)[None, :]
    ang = sign * 2.0 * np.pi * (k1 * m2 % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _best_split(n: int) -> Optional[Tuple[int, int]]:
    """Factor n = n1*n2 with both parts <= _MAX_FACTOR.

    Prefers an n2 that is a multiple of 128 (then 8), so the stage-1
    result and twiddle streams are tile-aligned; among
    candidates with the same alignment, the most balanced split wins."""
    best = None
    best_key = None
    for n1 in range(2, int(np.sqrt(n)) + 1):
        if n % n1 == 0:
            n2 = n // n1
            if n1 <= _MAX_FACTOR and n2 <= _MAX_FACTOR:
                for a, b in ((n1, n2), (n2, n1)):
                    key = (b % 128 == 0, b % 8 == 0, -abs(a - b))
                    if best_key is None or key > best_key:
                        best, best_key = (a, b), key
    return best


_PRECISION = jax.lax.Precision.HIGHEST


def _dg(z: jnp.ndarray, w: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Contract z's ``axis`` (-1 or -2) with w's axis 1 ([k, c]).

    axis=-2 yields [..., m, k]; axis=-1 yields [..., k]. A direct
    dot_general so XLA never materializes a transposed copy of z."""
    cdim = z.ndim + axis
    return jax.lax.dot_general(
        z, w, (((cdim,), (1,)), ((), ())),
        precision=_PRECISION, preferred_element_type=jnp.float32)


def _cmatmul(wr: np.ndarray, wi: np.ndarray, x: CF,
             side: str = "left") -> CF:
    """Complex contraction of x by the DFT matrix (wr + i wi) [k, c].

    side="left": contract x's -2 axis -> [..., m, k]  (NOTE: the result's
    free axis order swaps relative to w @ x — callers account for it).
    side="right": contract x's -1 axis -> [..., k].
    Four real dot_generals per complex matmul; no data transposes are
    emitted.
    """
    wr = jnp.asarray(wr)
    wi = jnp.asarray(wi)
    axis = -2 if side == "left" else -1
    rr = _dg(x.re, wr, axis) - _dg(x.im, wi, axis)
    ri = _dg(x.re, wi, axis) + _dg(x.im, wr, axis)
    return CF(rr, ri)


def fft_cf(x: CF, inverse: bool = False) -> CF:
    """DFT along the last axis of a CF array (any leading batch dims).

    Forward matches ``np.fft.fft``; inverse matches ``np.fft.ifft``
    (including the 1/N scale).
    """
    n = x.shape[-1]
    sign = 1.0 if inverse else -1.0
    split = _best_split(n)
    if split is None:
        wr, wi = _dft_mats(n, sign)
        y = _cmatmul(wr, wi, x, "right")                   # [..., k]
    else:
        n1, n2 = split
        a = x.reshape(*x.shape[:-1], n1, n2)
        w1r, w1i = _dft_mats(n1, sign)
        b = _cmatmul(w1r, w1i, a, "left")                  # [..., n2, k1]
        twr, twi = _twiddles(n1, n2, sign)
        c = b * CF(jnp.asarray(twr.T.copy()), jnp.asarray(twi.T.copy()))
        w2r, w2i = _dft_mats(n2, sign)
        d = _cmatmul(w2r, w2i, c, "left")                  # [..., k1, k2]
        y = d.swapaxes(-1, -2).reshape(*x.shape)           # X[N1*k2+k1]
    if inverse:
        y = y * jnp.float32(1.0 / n)
    return y


def ifft_cf(x: CF) -> CF:
    return fft_cf(x, inverse=True)
