"""Planar complex arithmetic: complex values as (re, im) float32 pairs.

The framework carries IQ data as an explicit ``CF(re, im)`` pytree of
two real planes instead of complex64 arrays: the planes feed real
elementwise ops and real matmuls (the matmul FFT, the banded FIRs)
without interleave shuffles. Whether complex64 with cuFFT would be
faster on the GPU is an open measurement (ROADMAP S3).

Host boundaries (files, numpy oracles, tests) still speak numpy
complex64; convert with :func:`from_complex` / :func:`to_complex`.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp
import numpy as np


class CF(NamedTuple):
    """A complex array as two same-shaped real arrays."""

    re: jnp.ndarray
    im: jnp.ndarray

    # -- arithmetic ---------------------------------------------------
    def __add__(self, o):
        if isinstance(o, CF):
            return CF(self.re + o.re, self.im + o.im)
        return CF(self.re + o, self.im)

    def __sub__(self, o):
        if isinstance(o, CF):
            return CF(self.re - o.re, self.im - o.im)
        return CF(self.re - o, self.im)

    def __mul__(self, o):
        if isinstance(o, CF):
            return CF(self.re * o.re - self.im * o.im,
                      self.re * o.im + self.im * o.re)
        return CF(self.re * o, self.im * o)

    def conj(self) -> "CF":
        return CF(self.re, -self.im)

    def abs2(self) -> jnp.ndarray:
        return self.re * self.re + self.im * self.im

    def abs(self) -> jnp.ndarray:
        return jnp.sqrt(self.abs2())

    # -- shape plumbing ----------------------------------------------
    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    def reshape(self, *s) -> "CF":
        return CF(self.re.reshape(*s), self.im.reshape(*s))

    def __getitem__(self, idx) -> "CF":
        return CF(self.re[idx], self.im[idx])

    def swapaxes(self, a, b) -> "CF":
        return CF(jnp.swapaxes(self.re, a, b), jnp.swapaxes(self.im, a, b))


def cf_zeros(shape, dtype=np.float32) -> CF:
    """Host-side zeros pair (numpy: uploaded when it enters a jitted
    call)."""
    return CF(np.zeros(shape, dtype), np.zeros(shape, dtype))


def from_complex(x) -> CF:
    """Host numpy complex -> CF of float32 (host arrays; device upload
    happens when they enter a jitted function)."""
    x = np.asarray(x)
    return CF(np.ascontiguousarray(x.real, dtype=np.float32),
              np.ascontiguousarray(x.imag, dtype=np.float32))


def to_complex(x: CF) -> np.ndarray:
    """CF -> host numpy complex64."""
    return (np.asarray(x.re) + 1j * np.asarray(x.im)).astype(np.complex64)


def as_cf(x) -> CF:
    """Accept CF, numpy complex, or numpy/jnp real arrays (im = 0)."""
    if isinstance(x, CF):
        return x
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        return from_complex(x)
    if hasattr(x, "dtype") and jnp.iscomplexobj(x):
        # device complex: only legal on backends with complex support
        return CF(x.real.astype(jnp.float32), x.imag.astype(jnp.float32))
    return CF(jnp.asarray(x, jnp.float32),
              jnp.zeros_like(jnp.asarray(x, jnp.float32)))


def concat(parts, axis=-1) -> CF:
    return CF(jnp.concatenate([p.re for p in parts], axis=axis),
              jnp.concatenate([p.im for p in parts], axis=axis))


def where(cond, a: CF, b: CF) -> CF:
    return CF(jnp.where(cond, a.re, b.re), jnp.where(cond, a.im, b.im))
