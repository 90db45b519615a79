"""FIR design and application.

Design follows the reference's windowed-sinc band-pass with symmetric
Hamming window (demod.java:341-375, fir.java:166-195). Application is
batched array code instead of a per-sample circular delay buffer:

- ``fir_apply``: causal FIR as one dense matmul against a banded tap
  matrix
- ``fir_apply_fft``: overlap-save frequency-domain convolution for long
  blocks / long filters
- ``polyphase_decimate``: decimate-by-M FIR that evaluates only the kept
  outputs, exactly matching the reference's "accumulate M samples then
  dot" loop (FUNcubeBPSKDemod.java:470-492) at 1/M of the naive FLOPs
- ``mix_decimate``: the telemetry front end's periodic-pattern tuner mix
  followed by ``polyphase_decimate``
- streaming variants thread a (ntaps-1)-sample tail as explicit state so
  block boundaries are seamless (the carried-pytree analog of the delay
  buffers at demod.java:378-396)
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .cplx import CF


def bandpass_weights(ntaps: int, f_lo: float, f_hi: float, rate: float,
                     dtype=jnp.float32) -> jnp.ndarray:
    """Windowed-sinc band-pass taps, Hamming windowed (demod.java:341-370).

    ``f_lo == None`` designs the all-pass (unit impulse at center tap,
    demod.java:343-347). Tap n multiplies the sample n steps in the past
    (newest-first convention of the reference delay loop).
    """
    if f_lo is None:
        w = np.zeros(ntaps)
        w[(ntaps - 1) // 2] = 1.0
        return jnp.asarray(w, dtype)
    nlo = f_lo / rate
    nhi = f_hi / rate
    ord_ = ntaps - 1
    n = np.arange(ntaps)
    m = n - ord_ // 2
    with np.errstate(invalid="ignore", divide="ignore"):
        w = (np.sin(2 * np.pi * nhi * m) - np.sin(2 * np.pi * nlo * m)) / (np.pi * m)
    w[ord_ // 2] = 2.0 * (nhi - nlo)
    w *= 0.54 - 0.46 * np.cos(2 * np.pi * n / ord_)
    return jnp.asarray(w, dtype)


def _bf16x3_dot(a, b):
    """f32 matmul as THREE products of hi/lo splits (hi*hi + hi*lo +
    lo*hi), each at DEFAULT precision.

    hi = the operand rounded to bf16; lo = the f32 remainder. The dropped
    lo*lo term is O(2^-16) relative. At DEFAULT precision a backend may
    round the operands of each product (to bf16 or TF32); the hi parts
    are bf16 values and survive either rounding exactly, and rounding a
    lo part costs at most 2^-8 of lo, i.e. O(2^-16) of the operand. On
    the CPU the three products are exact f32.

    The rounding is ``lax.reduce_precision``, not an f32 -> bf16 -> f32
    cast pair: XLA's GPU compiler may drop such a pair (excess precision
    is allowed by default), which leaves lo = 0 and the whole product at
    DEFAULT precision, about 2^-9 relative on the H100."""
    ah = lax.reduce_precision(a, exponent_bits=8, mantissa_bits=7)
    al = a - ah
    bh = lax.reduce_precision(b, exponent_bits=8, mantissa_bits=7)
    bl = b - bh
    f = lambda x, y: jnp.dot(x, y, precision=lax.Precision.DEFAULT,
                             preferred_element_type=jnp.float32)
    return f(ah, bh) + f(ah, bl) + f(al, bh)


def _banded_matmul_fir(z: jnp.ndarray, taps: jnp.ndarray, m: int,
                       n_out: int,
                       precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """Decimate-by-m FIR y[k] = sum_a z[s_a + k*m] * taps[a] with
    s_a = (m-1) + (ntaps-1) - a, as blocks of 128 outputs x ONE dense
    matmul against a static banded tap matrix (im2col via a single
    shifted-row concat), reading contiguous rows instead of strided
    slices.

    z: [..., >= n_out*m + ntaps - 1] padded input; returns [..., n_out].
    """
    ntaps = taps.shape[0]
    block = 128
    span = block * m
    ext = -(-(ntaps - 1) // block) * block       # lane-aligned halo
    nb = -(-n_out // block)
    i_idx = np.arange(span + ext)[:, None]
    o_idx = np.arange(block)[None, :]
    a_idx = o_idx * m + (m - 1) + (ntaps - 1) - i_idx
    w_mask = (a_idx >= 0) & (a_idx < ntaps)
    w_full = np.where(w_mask, a_idx, 0)
    tapmat = jnp.where(jnp.asarray(w_mask),
                       taps[jnp.asarray(w_full)],
                       jnp.zeros((), taps.dtype))        # [span+ext, block]
    lead = z.shape[:-1]
    width = span + ext
    qrows = -(-width // span)                # shifted row-slices needed
    nrows = max(nb + qrows - 1, -(-z.shape[-1] // span))
    zp = jnp.pad(z, [(0, 0)] * (z.ndim - 1)
                 + [(0, nrows * span - z.shape[-1])])
    rows = zp.reshape(*lead, nrows, span)
    parts = []
    for b in range(qrows):
        cols = min(span, width - b * span)
        parts.append(rows[..., b:b + nb, :cols])
    zcat = jnp.concatenate(parts, axis=-1)   # [.., nb, span+ext]
    if precision == "bf16x3":
        y = _bf16x3_dot(zcat, tapmat)
    else:
        y = jnp.matmul(zcat, tapmat, precision=precision)
    return y.reshape(*lead, nb * block)[..., :n_out]


def _conv_valid(x: jnp.ndarray, taps: jnp.ndarray,
                precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """Causal FIR y[t] = sum_a x[t-a] * taps[a] over the valid region.

    x: [..., T]; returns [..., T - ntaps + 1] (y[0] corresponds to input
    index ntaps-1). Real taps, applied along the last axis — the m=1
    banded-matmul FIR (see _banded_matmul_fir).
    """
    ntaps = taps.shape[0]
    t_out = x.shape[-1] - ntaps + 1
    return _banded_matmul_fir(x, taps, 1, t_out, precision=precision)


def fir_apply(x, taps: jnp.ndarray):
    """FIR with zero prehistory: output aligned to input (y[t] uses
    x[t-ntaps+1..t], zeros before t=0). x: [..., T] real, complex, or CF."""
    ntaps = taps.shape[0]
    if isinstance(x, CF):
        return CF(fir_apply(x.re, taps), fir_apply(x.im, taps))
    pad = [(0, 0)] * (x.ndim - 1) + [(ntaps - 1, 0)]
    xp = jnp.pad(x, pad)
    if jnp.iscomplexobj(x):
        return (_conv_valid(xp.real, taps) + 1j * _conv_valid(xp.imag, taps)
                ).astype(x.dtype)
    return _conv_valid(xp, taps)


def fir_apply_streaming(x, taps: jnp.ndarray, tail,
                        precision=lax.Precision.HIGHEST):
    """FIR over a block with carried history.

    tail: [..., ntaps-1] previous samples (state). Returns (y, new_tail)
    with y the same length as x — identical to running the reference's
    per-sample delay-buffer loop across block boundaries. Accepts CF
    pairs (tail then also a CF). ``precision="bf16x3"`` runs the tap
    matmul as three split products (see :func:`_bf16x3_dot`) instead of
    one HIGHEST-precision f32 product.
    """
    if isinstance(x, CF):
        yr, tr = fir_apply_streaming(x.re, taps, tail.re, precision)
        yi, ti = fir_apply_streaming(x.im, taps, tail.im, precision)
        return CF(yr, yi), CF(tr, ti)
    xp = jnp.concatenate([tail, x], axis=-1)
    y = _conv_valid(xp.real, taps, precision)
    if jnp.iscomplexobj(x):
        y = (y + 1j * _conv_valid(xp.imag, taps, precision)).astype(x.dtype)
    new_tail = xp[..., x.shape[-1]:]
    return y, new_tail


def fir_apply_fft(x, taps: jnp.ndarray):
    """Overlap-free whole-block frequency-domain FIR (zero prehistory).

    For very long blocks the (matmul) FFT beats direct convolution;
    within fp tolerance of ``fir_apply``. x: real array or CF.
    """
    from .cplx import as_cf
    from .mxu_fft import fft_cf, ifft_cf

    ntaps = taps.shape[0]
    was_real = not isinstance(x, CF) and not (
        hasattr(x, "dtype") and jnp.iscomplexobj(x)) and not (
        isinstance(x, np.ndarray) and np.iscomplexobj(x))
    xc = as_cf(x)
    t = xc.shape[-1]
    n = t + ntaps - 1
    pad = [(0, 0)] * (xc.ndim - 1) + [(0, n - t)]
    xp = CF(jnp.pad(xc.re, pad), jnp.pad(xc.im, pad))
    X = fft_cf(xp)
    h = jnp.pad(taps.astype(jnp.float32), (0, n - ntaps))
    H = fft_cf(CF(h, jnp.zeros_like(h)))
    y = ifft_cf(X * H)[..., :t]
    return y.re if was_real else y


def polyphase_decimate(x, taps: jnp.ndarray, m: int,
                       tail=None, gain: float = 1.0):
    """Decimating FIR evaluated only at kept instants, as window-gather +
    tap contraction.

    Matches the reference decimator (FUNcubeBPSKDemod.java:470-492): with
    per-block sample indices t = 0..T-1, outputs are produced at
    t = m-1, 2m-1, ... and output k = gain * sum_a x[t_k - a] * taps[a].

    x: [..., T] with T % m == 0 (real, complex, or CF). tail: [...,
    ntaps-1] carried history (zeros for stream start). Returns
    (y [..., T//m], new_tail).
    """
    if isinstance(x, CF):
        yr, tr = polyphase_decimate(x.re, taps, m,
                                    None if tail is None else tail.re, gain)
        yi, ti = polyphase_decimate(x.im, taps, m,
                                    None if tail is None else tail.im, gain)
        return CF(yr, yi), CF(tr, ti)
    ntaps = taps.shape[0]
    t_len = x.shape[-1]
    assert t_len % m == 0, "block length must be a multiple of the decimation"
    if tail is None:
        tail = jnp.zeros((*x.shape[:-1], ntaps - 1), x.dtype)
    xp = jnp.concatenate([tail, x], axis=-1)
    # output k is taken at input instant t_k = (k+1)*m - 1, i.e. padded
    # index t_k + ntaps - 1; tap a reads padded index s_a + k*m with
    # s_a = (m-1) + (ntaps-1) - a — the banded-matmul FIR.
    n_out = t_len // m

    def dec1(z):
        return _banded_matmul_fir(z, taps, m, n_out)

    if jnp.iscomplexobj(x):
        y = (dec1(xp.real) + 1j * dec1(xp.imag)).astype(x.dtype)
    else:
        y = dec1(xp)
    new_tail = xp[..., t_len:]
    return y * gain, new_tail


def mix_decimate(iq: CF, cos_pat, sin_pat, taps, m: int, tail: CF,
                 gain: float = 1.0):
    """NCO mix by a 128-sample periodic pattern, then decimate-by-m FIR,
    over [S, T] stream rows.

    ``cos_pat``/``sin_pat``: [S, 128] per-stream mix tables, valid when
    the quantized NCO index sequence is 128-sample periodic (see
    ``demod.bpsk._nco_pattern``; pass ones for no mix). The mix is the
    reference's non-complex quirk (i*cos, q*sin). ``tail``: CF [S,
    ntaps-1] carried MIXED-domain history (the state of
    :func:`polyphase_decimate`). T must be a multiple of m. Returns
    (ds CF [S, T//m], new_tail CF)."""
    t = iq.shape[-1]
    reps = -(-t // 128)
    cos_full = jnp.tile(cos_pat, (1, reps))[:, :t]
    sin_full = jnp.tile(sin_pat, (1, reps))[:, :t]
    mixed = CF(iq.re * cos_full, iq.im * sin_full)
    return polyphase_decimate(mixed, jnp.asarray(taps, jnp.float32), m,
                              tail=tail, gain=gain)
