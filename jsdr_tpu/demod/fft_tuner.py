"""FFT auto-tune front-end — the ``doBufferFFT`` path of the reference
(FUNcubeBPSKDemod.java:399-464).

Per 0.1 s block: forward FFT, box-averaged PSD peak search in the lower
(or upper, ``track_high``) half-band with EMA-tracked peak power, centre
bin clamped >= 102, then a 204-bin slice around the peak is inverse-FFT'd
and ONLY ITS REAL PART is fed to the decimator (the reference drops Q —
a deliberate quirk of its C++ heritage, :462).

The computation is split by data dependence so it scales:

- ``tuner_precompute``: per-block FFT + box-averaged PSD + masked peak
  search — embarrassingly parallel over blocks (no carried state);
- ``tuner_recurrence``: the (avePeakPower, aveCentreBin, centreBin)
  state chain over blocks — a cheap ``lax.scan`` over tiny per-block
  reductions (the ONLY sequential part, scalar work per block);
- ``tuner_emit``: slice-around-centre + inverse FFT per block given the
  resolved centres — parallel again.

``fft_tuner_blocks`` composes the three for the single-chip path; the
sp-sharded step (parallel/sharded.py) runs precompute/emit locally per
time shard and resolves the recurrence across shards with a log-free
ppermute relay (the state is 3 scalars per stream). Transforms use the
planar matmul FFT (ops/mxu_fft.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.cplx import CF, as_cf
from ..ops.mxu_fft import fft_cf

# FUNcubeBPSKDemod.java:399-402
PSD_AVG = 2.0 / (10 + 1)
PSD_INV = 1.0 - PSD_AVG
SLICE_HALF = 102          # bins copied around the peak (:458)
BOX_HALF = 50             # box-average half width (:435)
EDGE = 75                 # peak-search guard band (:433)
MIN_CENTRE = 102          # clamp (:453)


class FftTunerState(NamedTuple):
    ave_peak_power: jnp.ndarray  # scalar f32
    ave_centre_bin: jnp.ndarray  # scalar f32
    centre_bin: jnp.ndarray      # scalar i32


def fft_tuner_init() -> FftTunerState:
    return FftTunerState(
        ave_peak_power=np.zeros((), np.float32),
        ave_centre_bin=np.zeros((), np.float32),
        centre_bin=np.zeros((), np.int32),
    )


def tuner_precompute(iq_blocks: CF, track_high):
    """Stateless per-block analysis (parallel over blocks).

    iq_blocks: CF [..., n_blocks, samples]. Returns (spec [..., n_blocks,
    samples] CF, ave [..., n_blocks, samples//2] box-summed PSD,
    bin_pos [..., n_blocks] i32, max_bin [..., n_blocks] f32, end
    [...] i32 — the half-band end used for the centre clamp).
    """
    samples = iq_blocks.shape[-1]
    spec = fft_cf(iq_blocks)
    psd = CF(spec.re[..., : samples // 2],
             spec.im[..., : samples // 2]).abs()

    # track_high is TRACED (bool, broadcastable over leading dims): the
    # search half-band is data, so per-instance FUNcube<n>-bpsk-upper
    # settings batch in one compile (FUNcubeBPSKDemod.java:97-99)
    th = jnp.asarray(track_high)
    beg = jnp.where(th, samples // 4, 0)
    end = jnp.where(th, samples // 2, samples // 4)
    zero = jnp.zeros(psd.shape[:-1] + (1,), psd.dtype)
    csum = jnp.cumsum(jnp.concatenate([zero, psd], axis=-1), axis=-1)
    # csum[clip(i +- BOX_HALF, 0, n/2)] is a SHIFT with clamped edges —
    # pure slices + edge broadcasts, no gather (values identical to
    # jnp.take)
    half = samples // 2
    hi_v = jnp.concatenate(
        [csum[..., BOX_HALF:],
         jnp.broadcast_to(csum[..., -1:],
                          (*csum.shape[:-1], BOX_HALF - 1))], axis=-1)
    lo_v = jnp.concatenate(
        [jnp.broadcast_to(csum[..., :1],
                          (*csum.shape[:-1], BOX_HALF)),
         csum[..., : half - BOX_HALF]], axis=-1)
    ave = hi_v - lo_v
    i_all = jnp.arange(half)
    in_range = ((i_all >= (beg + EDGE)[..., None])
                & (i_all < (end - EDGE)[..., None]))
    masked = jnp.where(in_range, ave, -jnp.inf)
    bin_pos = jnp.argmax(masked, axis=-1).astype(jnp.int32)
    max_bin = jnp.max(masked, axis=-1)    # == masked[argmax], gather-free
    return spec, ave, bin_pos, max_bin, end


def tuner_recurrence(state: FftTunerState, ave, bin_pos, max_bin, end
                     ) -> Tuple[FftTunerState, jnp.ndarray]:
    """The sequential EMA/centre chain over blocks (scalar work each).

    ave [n_blocks, samples//2], bin_pos/max_bin [n_blocks], end scalar.
    Returns (new state, centres [n_blocks] i32) — the per-block centre
    bins that drive the slice extraction.
    """

    def step(s: FftTunerState, x):
        ave_b, pos_b, max_b = x
        centre = jnp.clip(s.centre_bin, 0, end - 1)
        app = PSD_AVG * ave_b[centre] + PSD_INV * s.ave_peak_power
        take = (max_b > app * 1.25) & (pos_b > 0)
        acb = jnp.where(take, pos_b.astype(jnp.float32), s.ave_centre_bin)
        centre2 = jnp.where(take, (acb + 1.0).astype(jnp.int32), centre)
        centre2 = jnp.maximum(centre2, MIN_CENTRE)
        ns = FftTunerState(app.astype(jnp.float32), acb.astype(jnp.float32),
                           centre2)
        return ns, centre2

    # unroll: tiny per-step work, scan overhead dominates (the round-5
    # FEC lesson); values unchanged
    return lax.scan(step, state, (ave, bin_pos, max_bin), unroll=8)


@functools.lru_cache(maxsize=8)
def _idft_slice_mats(samples: int):
    """Constant [204, samples] iDFT of a spectrum that is zero outside
    bins 0..203 — the whole zero-pad + inverse FFT of the shipped emit
    collapses to one matmul of the slice values (host-exact f64 build)."""
    k = np.arange(2 * SLICE_HALF)[:, None]
    t = np.arange(samples)[None, :]
    ang = 2.0 * np.pi * (k * t % samples) / samples
    return (np.cos(ang).astype(np.float32) / samples,
            np.sin(ang).astype(np.float32) / samples)


def tuner_emit(spec: CF, centres: jnp.ndarray) -> CF:
    """Slice [centre-102, centre+102) -> inverse transform -> real-only
    feed (parallel over blocks). spec [n_blocks, samples] CF, centres
    [n_blocks] i32. Returns the CF feed [n_blocks, samples] with
    I = Q = re (the Q-drop quirk, :461-463).

    Gather-free end to end: the 204-bin slice is extracted with an EXACT one-hot row
    matmul (HIGHEST-precision f32 dot — unlike demod.bpsk._extract_rows
    the buffer holds arbitrary floats, so bf16 would round them) plus a
    7-step fine roll, and the zero-pad + inverse FFT collapses to ONE
    constant [204, samples] iDFT matmul of the slice (the padded
    spectrum is zero outside bins 0..203). Numerically equivalent to
    the per-block iFFT within ~2.5e-7 relative (the form it replaced
    was a vmapped dynamic slice + per-block iFFT)."""
    samples = spec.shape[-1]
    n_rows = samples // 128
    out_len = 2 * SLICE_HALF
    rows_out = -(-out_len // 128) + 1           # +1 row of roll spill
    start = jnp.clip(centres - SLICE_HALF, 0, samples - out_len)
    q = start // 128
    rr = start % 128
    i = jnp.arange(rows_out, dtype=jnp.int32)
    j = jnp.arange(n_rows, dtype=jnp.int32)
    onehot = (j[None, None, :] == (q[:, None] + i[None, :])[:, :, None]
              ).astype(jnp.float32)             # [nb, rows_out, n_rows]
    s2r = spec.re.reshape(-1, n_rows, 128)
    s2i = spec.im.reshape(-1, n_rows, 128)
    dn = (((2,), (1,)), ((0,), (0,)))
    hp = lax.Precision.HIGHEST
    sel_r = lax.dot_general(onehot, s2r, dn, precision=hp)
    sel_i = lax.dot_general(onehot, s2i, dn, precision=hp)
    fr = sel_r.reshape(-1, rows_out * 128)
    fi = sel_i.reshape(-1, rows_out * 128)
    for k in range(7):                          # fine roll left by rr
        s = 1 << k
        on = ((rr >> k) & 1 == 1)[:, None]
        fr = jnp.where(on, jnp.concatenate([fr[:, s:], fr[:, :s]], axis=1),
                       fr)
        fi = jnp.where(on, jnp.concatenate([fi[:, s:], fi[:, :s]], axis=1),
                       fi)
    sr = fr[:, :out_len]
    si = fi[:, :out_len]
    idr, idi = _idft_slice_mats(samples)
    feed_re = (jnp.dot(sr, jnp.asarray(idr), precision=hp)
               - jnp.dot(si, jnp.asarray(idi), precision=hp))
    return CF(feed_re, feed_re)


@jax.jit
def _fft_tuner_blocks_jit(iq_blocks: CF, state: FftTunerState,
                          track_high: jnp.ndarray):
    spec, ave, bin_pos, max_bin, end = tuner_precompute(iq_blocks,
                                                        track_high)
    new_state, centres = tuner_recurrence(state, ave, bin_pos, max_bin, end)
    feeds = tuner_emit(spec, centres)
    return feeds.reshape(-1), centres, new_state


def fft_tuner_blocks(iq_blocks, state: FftTunerState,
                     track_high=False
                     ) -> Tuple[CF, jnp.ndarray, FftTunerState]:
    """Auto-tune a sequence of 0.1 s blocks.

    iq_blocks: CF [n_blocks, samples] (or host complex). ``track_high``
    may be a python bool or a traced scalar bool (per-instance
    FUNcube<n>-bpsk-upper). Returns (feed CF [n_blocks*samples] with
    I=Q=real part, centre_bins [n_blocks] i32, new state).
    """
    return _fft_tuner_blocks_jit(as_cf(iq_blocks), state,
                                 jnp.asarray(track_high, bool))
