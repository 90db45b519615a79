"""Tensor-parallel FFT/PSD: ONE large DFT sharded across mesh devices.

This is the intra-op (TP) obligation from SURVEY §2.2 — the analog of
sharding a single huge batched FFT, as opposed to ``sharded_spectrum``'s
pure data-parallelism over independent blocks. It matters when a single
transform is too large for one device's memory (a wideband
channelizer over a long capture) or when per-FFT latency must scale
with device count.

The matmul FFT (ops/mxu_fft.py) decomposes N = N1*N2 into two dense
contractions; TP shards the FIRST contraction's reduction axis:

    stage 1: B[k1, n2]  = sum_n1 W1[k1, n1] * A[n1, n2]
             -> each device holds a CONTIGUOUS time slice
                A[n1_loc, n2] (rows of A are contiguous in time) and
                computes a partial B; one ``psum_scatter`` over the mesh
                axis both reduces the partials and leaves each device
                with its own k1 rows — the TP-matmul pattern.
    twiddle: local elementwise on the device's [k1_loc, n2] slice.
    stage 2: D[k1_loc, k2] = C[k1_loc, n2] @ W2^T — fully local.

Total communication: one psum_scatter of N complex values per FFT
(2 matmul stages of ~N*(N1+N2) FLOPs amortize it). Output is sharded
over k1 — a strided-frequency sharding under the final ordering
X[N1*k2 + k1]; ``gather=True`` all-gathers and reorders to natural
np.fft order for host display.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.cplx import CF, as_cf
from ..ops.mxu_fft import _MAX_FACTOR, _dft_mats, _twiddles
from ..ops.windows import hamming_np

_PRECISION = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=64)
def _tp_split(n: int, n_tp: int) -> Optional[Tuple[int, int]]:
    """Factor n = n1*n2 with n1 divisible by the TP degree (so both the
    time shards and the psum_scatter's k1 shards are equal), both parts
    <= the single-matmul cap. Prefers lane-aligned n2, then balance."""
    best, best_key = None, None
    for n1 in range(n_tp, _MAX_FACTOR + 1, n_tp):
        if n % n1 == 0:
            n2 = n // n1
            if n2 <= _MAX_FACTOR:
                key = (n2 % 128 == 0, n2 % 8 == 0, -abs(n1 - n2))
                if best_key is None or key > best_key:
                    best, best_key = (n1, n2), key
    return best


def _dg_nk(w: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """[k, c] x [b, c, m] -> [b, k, m] (contract c) without transposes."""
    return lax.dot_general(x, w, (((1,), (1,)), ((), ())),
                           precision=_PRECISION,
                           preferred_element_type=jnp.float32
                           ).swapaxes(-1, -2)


def _dg_right(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """[b, k, c] x [j, c] -> [b, k, j] (contract c)."""
    return lax.dot_general(x, w, (((2,), (1,)), ((), ())),
                           precision=_PRECISION,
                           preferred_element_type=jnp.float32)


def tp_fft(mesh: Mesh, n: int, tp_axis: str = "sp", dp_axis: str = "dp",
           gather: bool = True, window: bool = False):
    """Build a jitted tensor-parallel FFT over ``mesh``.

    Returns ``fn(x)`` for x [B, n] (CF or complex); B is sharded over
    ``dp_axis`` and each row's time axis over ``tp_axis``. With
    ``gather=True`` the result is [B, n] in np.fft order (replicated
    along tp); otherwise [B, n1_loc(n/tp), n2]-sharded stage output
    D[k1, k2] for fused downstream consumption.

    ``window=True`` applies the Hamming window on the sharded time axis
    before the transform (each shard windows its own slice — the window
    is a host constant sliced per shard, zero extra comm).
    """
    n_tp = mesh.shape[tp_axis]
    split = _tp_split(n, n_tp)
    assert split is not None, f"no TP split for n={n}, tp={n_tp}"
    n1, n2 = split
    n1_loc = n1 // n_tp
    sign = -1.0

    w1r_h, w1i_h = _dft_mats(n1, sign)       # [k1, n1]
    w2r_h, w2i_h = _dft_mats(n2, sign)       # [k2, n2]
    twr_h, twi_h = _twiddles(n1, n2, sign)   # [k1, n2]
    win_h = hamming_np(n).astype(np.float32).reshape(n1, n2)

    def local(xr, xi):
        i = lax.axis_index(tp_axis)
        x = CF(xr, xi).reshape(xr.shape[0], n1_loc, n2)
        if window:
            w = lax.dynamic_slice_in_dim(jnp.asarray(win_h),
                                         i * n1_loc, n1_loc, axis=0)
            x = CF(x.re * w, x.im * w)
        # stage 1 partial: this shard's n1 rows of A against its W1 cols
        w1r = lax.dynamic_slice_in_dim(jnp.asarray(w1r_h),
                                       i * n1_loc, n1_loc, axis=1)
        w1i = lax.dynamic_slice_in_dim(jnp.asarray(w1i_h),
                                       i * n1_loc, n1_loc, axis=1)
        br = _dg_nk(w1r, x.re) - _dg_nk(w1i, x.im)       # [b, k1, n2] partial
        bi = _dg_nk(w1r, x.im) + _dg_nk(w1i, x.re)
        # reduce partials + scatter k1 rows in one collective
        br = lax.psum_scatter(br, tp_axis, scatter_dimension=1, tiled=True)
        bi = lax.psum_scatter(bi, tp_axis, scatter_dimension=1, tiled=True)
        # twiddle (local k1 slice)
        twr = lax.dynamic_slice_in_dim(jnp.asarray(twr_h),
                                       i * n1_loc, n1_loc, axis=0)
        twi = lax.dynamic_slice_in_dim(jnp.asarray(twi_h),
                                       i * n1_loc, n1_loc, axis=0)
        cr = br * twr - bi * twi
        ci = br * twi + bi * twr
        # stage 2 (fully local): contract n2
        dr = _dg_right(cr, jnp.asarray(w2r_h)) - _dg_right(ci, jnp.asarray(w2i_h))
        di = _dg_right(cr, jnp.asarray(w2i_h)) + _dg_right(ci, jnp.asarray(w2r_h))
        if not gather:
            return dr, di
        # all_gather k1 -> [b, k1, k2]; reorder X[N1*k2 + k1]
        dr = lax.all_gather(dr, tp_axis, axis=1, tiled=True)
        di = lax.all_gather(di, tp_axis, axis=1, tiled=True)
        y = CF(dr, di).swapaxes(-1, -2).reshape(xr.shape[0], n)
        return y.re, y.im

    out_sp = (P(dp_axis, None) if gather
              else P(dp_axis, tp_axis, None))
    smapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(dp_axis, tp_axis), P(dp_axis, tp_axis)),
        out_specs=(out_sp, out_sp),
        check_vma=False)
    jitted = jax.jit(smapped)

    def run(x) -> CF:
        x = as_cf(x)
        return CF(*jitted(x.re, x.im))

    return run


def tp_spectrum(mesh: Mesh, n: int, rate: float, tp_axis: str = "sp",
                dp_axis: str = "dp", window: bool = True):
    """PSD (dBFS) of one large windowed FFT per batch row, the transform
    itself sharded over ``tp_axis`` — the fft.java PSD formula
    (fft.java:197-207) applied at a size no single reference block could
    reach. Returns fn(x [B, n]) -> (psd_db [B, n], peak_freq [B],
    peak_db [B]) with the reference's bin -> +/-Hz int truncation
    (fft.java:208-221)."""
    fft = tp_fft(mesh, n, tp_axis=tp_axis, dp_axis=dp_axis,
                 gather=True, window=window)
    scale2 = np.float32((2.0 / n) ** 2)

    @jax.jit
    def finish(re, im):
        p = (re * re + im * im) * scale2
        db = 10.0 * jnp.log10(jnp.maximum(p, 1e-30))
        from ..ops.spectrum import bin_to_hz
        k = jnp.argmax(db, axis=-1)
        signed = jnp.where(k < n // 2, k, k - n)
        freq = bin_to_hz(signed, int(rate), n).astype(jnp.int32)
        return db, freq, jnp.take_along_axis(db, k[:, None], -1)[:, 0]

    def run(x):
        y = fft(x)
        return finish(y.re, y.im)

    return run
