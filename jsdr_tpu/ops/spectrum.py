"""Batched FFT spectrum / PSD — the replacement for fft.java.

The reference transforms each 0.1 s block with JTransforms and computes a
dBFS PSD plus the spectral maximum per block (fft.java:190-228). Here
blocks are batched [B, N] planar pairs (:mod:`jsdr_tpu.ops.cplx`), the
transform is the matmul FFT (:mod:`jsdr_tpu.ops.mxu_fft`), and the whole
thing is one XLA graph.

PSD convention (fft.java:197-207, after pysdr.org):
    psd = 10*log10((re^2 + im^2) * (2/N)^2)
Frequency convention for the argmax (fft.java:208-221): bin p maps to
+p*rate/N for p < N/2 and (p - N)*rate/N above.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .cplx import CF, as_cf
from .mxu_fft import fft_cf
from .windows import hamming

_EPS = 1e-30  # avoid log(0); reference happily takes -inf


def bin_to_hz(signed_bin: jnp.ndarray, rate: int, n: int) -> jnp.ndarray:
    """floor(signed_bin * rate / n) without int32 overflow.

    The naive ``signed * rate // n`` wraps for large transforms
    (n=192000 at 96 kS/s puts |bin*rate| ~ 2.4e9 past int32); reduce by
    gcd, then split the division: for a = q*n' + s (0 <= s < n'),
    floor(a*r'/n') = q*r' + floor(s*r'/n') — every product stays within
    int32 for any realistic rate/n pair. Keeps the reference's integer
    truncation convention (fft.java:215-220)."""
    import math
    g = math.gcd(int(rate), int(n))
    r, m = int(rate) // g, int(n) // g
    if m == 1:
        return signed_bin * r
    q = signed_bin // m
    s = signed_bin % m          # nonneg for positive m (floor semantics)
    return q * r + (s * r) // m


class SpectrumResult(NamedTuple):
    psd: jnp.ndarray       # [..., N] dBFS
    peak_freq: jnp.ndarray  # [...] Hz (signed)
    peak_db: jnp.ndarray    # [...]


def psd_dbfs(spec: CF) -> jnp.ndarray:
    """Planar spectrum -> dBFS PSD with the (2/N)^2 correction."""
    n = spec.shape[-1]
    cf = (2.0 / n) ** 2
    power = spec.abs2() * cf
    return 10.0 * jnp.log10(jnp.maximum(power, _EPS))


def spectrum_block(iq, rate: float, window: bool = True) -> SpectrumResult:
    """Windowed FFT + PSD + peak search over [..., N] blocks.

    ``iq``: CF pair (or host numpy complex, converted). ``window=False``
    reproduces the reference's quirk of computing but never applying the
    Hamming window (fft.java:71-73 vs :193).
    """
    iq = as_cf(iq)
    n = iq.shape[-1]
    x = iq * hamming(n) if window else iq
    spec = fft_cf(x)
    psd = psd_dbfs(spec)
    p = jnp.argmax(psd, axis=-1)
    peak_db = jnp.max(psd, axis=-1)     # == psd[argmax], gather-free
    signed = jnp.where(p < n // 2, p, p - n)
    # integer truncation parity with fft.java:215-220 (int arithmetic)
    peak_freq = bin_to_hz(signed, int(rate), n)
    return SpectrumResult(psd, peak_freq.astype(jnp.int32), peak_db)


def wf_group_for(n: int, max_width: int = 2048) -> int:
    """Display max-decimation group: the smallest divisor q of n with
    n // q <= max_width (96 kS/s: n = 9600 -> q = 5, 1920 pixels;
    192 kS/s: n = 19200 -> q = 10, 1920 pixels)."""
    return next(q for q in range(1, n + 1)
                if n % q == 0 and n // q <= max_width)


class WaterfallOut(NamedTuple):
    wf: jnp.ndarray         # [S, T//n, n//q] dB max-decimated lines
    peak_freq: jnp.ndarray  # [S, T//n] Hz (signed, reference truncation)
    peak_db: jnp.ndarray    # [S, T//n]


@partial(jax.jit, static_argnames=("n", "rate", "window"))
def spectrum_waterfall(iq: CF, n: int, rate: int,
                       window: bool = True) -> WaterfallOut:
    """Display spectrum over contiguous [S, T] stream rows, n samples per
    block (T % n == 0): :func:`spectrum_block` on every block, with the
    PSD max-decimated to display width.

    The waterfall display max-decimates the PSD to screen width before
    the intensity map (waterfall.java:90-107 after fft.java's per-pixel
    max, fft.java:142-150). Pixel p of a line is the max over natural
    bins [q*p, q*p + q), q = ``wf_group_for(n)``; since the
    intensity map is monotone, max-then-map equals map-then-max, and any
    further max-decimation to a narrower screen stays exact. Peaks are
    spectrum_block's: the full-resolution maximum and its first
    occurrence in natural bin order."""
    s, t = iq.shape
    with jax.named_scope("spectrum"):
        res = spectrum_block(iq.reshape(s, t // n, n), rate=rate,
                             window=window)
        q = wf_group_for(n)
        wf = jnp.max(res.psd.reshape(s, t // n, n // q, q), axis=-1)
    return WaterfallOut(wf, res.peak_freq, res.peak_db)


def psd_waterfall(spec, width: int):
    """[B, N] spectrum (CF pair or complex) -> (psd_db [B, N] f32,
    line [B, width] u8): dBFS PSD, max-decimated to ``width`` (which
    must divide N) and mapped to waterfall intensity in centred
    frequency order (0 Hz mid-screen, waterfall.java:96-106)."""
    spec = as_cf(spec)
    assert spec.shape[-1] % width == 0, "width must divide the FFT size"
    return _psd_waterfall(spec, width)


@partial(jax.jit, static_argnames=("width",))
def _psd_waterfall(spec: CF, width: int):
    db = psd_dbfs(spec)
    n = db.shape[-1]
    dec = jnp.max(db.reshape(*db.shape[:-1], width, n // width), axis=-1)
    line = jnp.roll(waterfall_intensity(dec), width // 2, axis=-1)
    return db, line


@jax.jit
def waterfall_intensity(psd: jnp.ndarray) -> jnp.ndarray:
    """Map dBFS PSD lines to 0..255 intensity as the waterfall display does
    (waterfall.java:90-107: 255 - psd * -2.55, clamped)."""
    f = 255.0 - psd * -2.55
    return jnp.clip(f, 0.0, 255.0).astype(jnp.uint8)


def psd_with_maxima(res: SpectrumResult) -> jnp.ndarray:
    """Pack PSD lines in the reference's publish convention: the PSD
    followed by two trailing floats [peak_freq, peak_db]
    (fft.java:222-226, consumed by waterfall.java:28-36)."""
    extras = jnp.stack([res.peak_freq.astype(res.psd.dtype),
                        res.peak_db.astype(res.psd.dtype)], axis=-1)
    return jnp.concatenate([res.psd, extras], axis=-1)
