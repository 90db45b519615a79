"""FUNcube 1200 bps BPSK telemetry demodulator — a batched re-design of
FUNcubeBPSKDemod.java.

The reference runs one scalar state machine per input sample. Here the
chain is split by data dependence:

  parallel (batched XLA ops, no recurrence):
    1. software tuner NCO mix at the input rate (:366-397)
    2. decimating 27-tap FIR to 9600 S/s as a window-gather contraction
       (:466-492), x the "Howard fudge factor" 0.9*32768 (:469)
    3. 1200 Hz VCO quadrature mix (:511-516) — the VCO increment is
       exactly pi/4 per decimated sample, so the whole trajectory is an
       8-entry table indexed by a carried counter
    4. 65-tap root-raised-cosine matched filter (:57-77, 518-523)

  timing recovery (:505-595) — parallel by default:
    5. bit-energy timing + differential bit decisions. The reference's
       double-precision bit-phase accumulator wraps at exactly 8 samples
       forever (verified numerically), so bit phase is a pure counter and
       samples group into bit periods; ``_timing_parallel`` then computes
       the whole recurrence with associative scans (log depth — see its
       docstring). ``compat_scan=True`` selects the per-sample
       ``lax.scan`` (``_timing_scan``) whose fp evaluation order matches
       the reference exactly; both produce identical bits on real
       signals (tested).

  batched again:
    6. bit compaction, stride-80 sync correlation against the 65-symbol
       vector at EVERY bit position (:556-559), frame-window extraction,
       soft mapping 0xc0/0x40 (:562-564). FEC decode of the extracted
       windows batches across hits/streams (jsdr_tpu.fec.decoder).

All carried state is one explicit pytree (``BpskState``) so streams chain
block-to-block and checkpoint trivially.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..fec.tables import SYNC_VECTOR
from ..ops.cplx import CF, as_cf, cf_zeros
from ..ops.fir import fir_apply_streaming, mix_decimate, polyphase_decimate
from ..ops.spectrum import spectrum_waterfall
from .fft_tuner import FftTunerState, fft_tuner_blocks, fft_tuner_init

# Constants from FUNcubeBPSKDemod.java:26-92
DOWN_SAMPLE_RATE = 9600
BIT_RATE = 1200
SAMPLES_PER_BIT = DOWN_SAMPLE_RATE // BIT_RATE          # 8
HOWARD_FUDGE_FACTOR = 0.9 * 32768.0                      # :56, :469
BIT_SMOOTH1 = 1.0 / 200.0
BIT_SMOOTH2 = 1.0 / 800.0
ENERGY_GATE = 100.0                                      # :544
SYNC_THRESHOLD = 45                                      # :560
FEC_BITS = 5200
SINCOS_SIZE = 256
TWO_PI = 2.0 * np.pi

# 27-tap decimation low-pass (FUNcubeBPSKDemod.java:27-55); quantized
# constants from the original C heritage (multiples of 2^-13).
DS_FILTER = np.array([
    -6.103515625000e-004, -1.220703125000e-004, +2.380371093750e-003,
    +6.164550781250e-003, +7.324218750000e-003, +7.629394531250e-004,
    -1.464843750000e-002, -3.112792968750e-002, -3.225708007813e-002,
    -1.617431640625e-003, +6.463623046875e-002, +1.502380371094e-001,
    +2.231445312500e-001, +2.518310546875e-001, +2.231445312500e-001,
    +1.502380371094e-001, +6.463623046875e-002, -1.617431640625e-003,
    -3.225708007813e-002, -3.112792968750e-002, -1.464843750000e-002,
    +7.629394531250e-004, +7.324218750000e-003, +6.164550781250e-003,
    +2.380371093750e-003, -1.220703125000e-004, -6.103515625000e-004,
])

# 65-tap root-raised-cosine matched filter (FUNcubeBPSKDemod.java:58-77;
# single copy — the reference duplicates it only for wrap-free indexing).
DM_FILTER = np.array([
    -0.0101130691, -0.0086975143, -0.0038246093, +0.0033563764,
    +0.0107237026, +0.0157790936, +0.0164594107, +0.0119213911,
    +0.0030315224, -0.0076488191, -0.0164594107, -0.0197184277,
    -0.0150109226, -0.0023082460, +0.0154712381, +0.0327423589,
    +0.0424493086, +0.0379940454, +0.0154712381, -0.0243701991,
    -0.0750320094, -0.1244834076, -0.1568500423, -0.1553748911,
    -0.1061032953, -0.0015013786, +0.1568500423, +0.3572048240,
    +0.5786381191, +0.7940228249, +0.9744923010, +1.0945250059,
    +1.1366117829, +1.0945250059, +0.9744923010, +0.7940228249,
    +0.5786381191, +0.3572048240, +0.1568500423, -0.0015013786,
    -0.1061032953, -0.1553748911, -0.1568500423, -0.1244834076,
    -0.0750320094, -0.0243701991, +0.0154712381, +0.0379940454,
    +0.0424493086, +0.0327423589, +0.0154712381, -0.0023082460,
    -0.0150109226, -0.0197184277, -0.0164594107, -0.0076488191,
    +0.0030315224, +0.0119213911, +0.0164594107, +0.0157790936,
    +0.0107237026, +0.0033563764, -0.0038246093, -0.0086975143,
    -0.0101130691,
])

# VCO: phase advances exactly pi/4 per decimated sample; with the 256-entry
# table quantization the 8 distinct (cos, sin) values are at bins k*32
_VCO_ANG = (np.arange(1, 9) % 8) * (TWO_PI / 8.0)   # phase of sample k ~ (k+1)
_VCO_COS = np.cos(_VCO_ANG).astype(np.float32)
_VCO_SIN = np.sin(_VCO_ANG).astype(np.float32)

_SYNC = np.asarray(SYNC_VECTOR, dtype=np.int32)     # [65] of +/-1


class BpskConfig(NamedTuple):
    rate: int = 96000          # input sample rate
    tuning: float = 12000.0    # default manual-tune NCO Hz for streams
                               # without an explicit per-stream tuning
    max_hits_per_block: int = 4
    dofft: bool = False        # FFT auto-tune front-end (doBufferFFT path)
    track_high: bool = False   # auto-tune searches the upper half-band
    compat_scan: bool = False  # per-sample lax.scan timing (exact-order
                               # fp parity) instead of the parallel path

    @property
    def decim(self) -> int:
        # integer ratio, faithfully truncating like adsc.rate/9600 (:476)
        return self.rate // DOWN_SAMPLE_RATE


class TimingState(NamedTuple):
    e_ema: jnp.ndarray      # [8] f32 smoothed bit energy per phase
    pos: jnp.ndarray        # scalar i32: dmBitPos
    peak: jnp.ndarray      # scalar i32: dmPeakPos
    new_peak: jnp.ndarray   # scalar i32: dmNewPeak
    e_out: jnp.ndarray      # scalar f32: dmEnergyOut
    last_iq: jnp.ndarray    # [2] f32: dmLastIQ


class BpskState(NamedTuple):
    tu_phase: jnp.ndarray   # scalar f32 tuner NCO phase NUMERATOR in
                            # [0, NU_SCALE*rate) — phase = 2pi*nu/den
    ds_tail: CF             # [26] planar decimator history
    vco_idx: jnp.ndarray    # scalar i32 decimated-sample counter mod 8
    mf_tail: CF             # [64] planar matched-filter history
    timing: TimingState
    ring: jnp.ndarray       # [5199] i8 last bits (+1/-1; 0 = unfilled)
    counters: jnp.ndarray   # [4] i32: raw, ds, bit, fec(sync hits)
    fft_tuner: "FftTunerState"  # auto-tune EMA state (dofft path)


def bpsk_init(cfg: BpskConfig) -> BpskState:
    # host-side numpy leaves: uploaded when they enter a jitted call, so
    # building a state costs no device transfer
    return BpskState(
        tu_phase=np.zeros((), np.float32),
        ds_tail=cf_zeros(len(DS_FILTER) - 1),
        vco_idx=np.zeros((), np.int32),
        mf_tail=cf_zeros(len(DM_FILTER) - 1),
        timing=TimingState(
            e_ema=np.zeros(SAMPLES_PER_BIT, np.float32),
            pos=np.zeros((), np.int32),
            peak=np.zeros((), np.int32),
            new_peak=np.zeros((), np.int32),
            e_out=np.ones((), np.float32),
            last_iq=np.zeros(2, np.float32),
        ),
        ring=np.zeros(FEC_BITS - 1, np.int8),
        counters=np.zeros(4, np.int32),
        fft_tuner=fft_tuner_init(),
    )


# ---------------------------------------------------------------------------
# Tuner NCO as an integer phase NUMERATOR, in 0.1 Hz units.
#
# The carried tuner phase is a numerator nu with phase =
# 2*pi*nu/(NU_SCALE*rate), nu in [0, NU_SCALE*rate). The reference's
# tuning config key is an integer property (jsdr.java:87-95,
# FUNcube<n>-bpsk-tuning); storing numerators in tenth-Hz units keeps
# every integral tuning exact AND extends the exact path to any tuning
# that is a multiple of 0.1 Hz (round 3 pushed fractional tunings onto
# a host-ramp path that recompiled per tuning set):
#
#   nu_k        = (nu_0 + k*tu10) mod den,  den = NU_SCALE*rate,
#                 tu10 = tuning in 0.1 Hz   (phase after k samples)
#   table index = floor(SINCOS_SIZE * nu_k / den)     (:93-95, 381-397)
#
# All intermediates stay inside int32 (worst case at 192 kS/s:
# den = 1.92e6; kram tu*127 < 2.5e8; c0ram < 1.97e9 < 2^31). Table
# indices for integral tunings are IDENTICAL to the rate-unit form
# (floor(256*10v/10rate) == floor(256*v/rate)), so behavior is
# bit-for-bit unchanged there. Per-stream tunings are a TRACED [S]
# int32 array — N demod instances with independent tunings run in ONE
# compiled step and retuning never recompiles (the analog of N
# FUNcubeBPSKDemod tabs, jsdr.java:479-484) — and shard phase offsets
# in parallel/sharded.py are exact by construction.
# ---------------------------------------------------------------------------

NU_SCALE = 10                 # numerator units per Hz (0.1 Hz resolution)


def _modmul_static(tu: jnp.ndarray, m: int, den: int) -> jnp.ndarray:
    """(m * tu) mod den for traced int32 tu in [0, den), static int m
    (any sign/size). Binary double-and-add keeps every value < 2*den,
    comfortably inside int32 for den <= NU_SCALE*192000."""
    m = int(m) % den
    acc = jnp.zeros_like(tu)
    cur = tu % den
    while m:
        if m & 1:
            acc = (acc + cur) % den
        cur = (cur + cur) % den
        m >>= 1
    return acc


def _modmul_traced(tu: jnp.ndarray, k: jnp.ndarray, den: int,
                   k_bits: int = 21) -> jnp.ndarray:
    """(k * tu) mod den with BOTH operands traced int32 in [0, den)
    (21 bits cover k < 2^21 > NU_SCALE*192000)."""
    acc = jnp.zeros_like(tu)
    cur = tu % den
    for j in range(k_bits):
        acc = jnp.where((k >> j) & 1 == 1, (acc + cur) % den, acc)
        cur = (cur + cur) % den
    return acc


def nco_numerators(nu0: jnp.ndarray, tu: jnp.ndarray, n: int, den: int,
                   start: int = 1) -> jnp.ndarray:
    """[..., n] exact phase numerators (nu0 + (start+i)*tu) mod den for
    i in [0, n), traced int32 tunings. Two-level split i = 128*c + k
    keeps all products in int32 up to n ~ 1.4e8 samples at 192 kS/s
    (~2.9e8 at 96 k): the binding factor is c1ram's step_l2*(c1_cnt-1)
    < 2^31 at den = NU_SCALE*rate, guarded by the assert below (the
    tenth-Hz denominator cut the round-3 ~1.4e9 headroom 10x). A 1.4e8-
    sample dispatch is ~12 minutes of 192 k stream — far past the
    executor's 1 s blocks; chained steps reset n per call."""
    tu = tu % den
    base0 = (nu0 + _modmul_static(tu, start, den)) % den
    kram = (tu[..., None]
            * jnp.arange(128, dtype=jnp.int32)) % den           # [..., 128]
    step128 = (tu * 128) % den
    c_cnt = -(-n // 128)
    c0_cnt = min(1024, c_cnt)
    c1_cnt = -(-c_cnt // c0_cnt)
    assert c1_cnt * (den - 1) < 2 ** 31
    step_l2 = (step128 * c0_cnt) % den
    c1ram = (step_l2[..., None]
             * jnp.arange(c1_cnt, dtype=jnp.int32)) % den       # [..., c1]
    c0ram = (step128[..., None]
             * jnp.arange(c0_cnt, dtype=jnp.int32)) % den       # [..., c0]
    base_c = (c1ram[..., :, None] + c0ram[..., None, :]) % den
    base_c = base_c.reshape(*base_c.shape[:-2], -1)[..., :c_cnt]
    nums = (base0[..., None, None] + base_c[..., None]
            + kram[..., None, :]) % den                         # [..., c, 128]
    return nums.reshape(*nums.shape[:-2], -1)[..., :n]


def _num_to_cossin(nums: jnp.ndarray, den: int):
    """Numerators -> quantized-table (cos, sin) values (:93-95)."""
    idx = (nums * SINCOS_SIZE) // den
    ang = idx.astype(jnp.float32) * np.float32(TWO_PI / SINCOS_SIZE)
    return jnp.cos(ang), jnp.sin(ang)


def _nco_pattern(nu0: jnp.ndarray, tu: jnp.ndarray, rate: int):
    """[..., 128] quantized-table mix pattern (cos, sin) for the fused
    mix+decimate kernel. ``tu`` is in 0.1 Hz numerator units
    (NU_SCALE); valid as a periodic broadcast iff each stream's
    (128 * tu10) % (NU_SCALE*rate) == 0 (checked by the dispatch
    wrapper); tu <= 0 streams pass through un-mixed (:388, :394-396)."""
    den = NU_SCALE * rate
    nums = nco_numerators(nu0.astype(jnp.int32), tu, 128, den, start=1)
    c, s = _num_to_cossin(nums, den)
    on = (tu > 0)[..., None]
    return jnp.where(on, c, 1.0), jnp.where(on, s, 1.0)


def _nco_advance(nu0: jnp.ndarray, tu: jnp.ndarray, rate: int, n: int):
    """Carried numerator after n samples (tu <= 0: phase frozen); tu in
    NU_SCALE (0.1 Hz) units, numerator modulo NU_SCALE*rate."""
    den = NU_SCALE * rate
    adv = (nu0.astype(jnp.int32) + _modmul_static(tu % den, n, den)) % den
    return jnp.where(tu > 0, adv, nu0.astype(jnp.int32)).astype(jnp.float32)


def _tuner_full_mix(iq: CF, nu0: jnp.ndarray, tu: jnp.ndarray, rate: int):
    """Full-length quantized-table tuner mix (mi = i*cos, mq = q*sin —
    the reference's non-complex quirk, :389-390) for traced integral
    tunings of ANY period — the general path when the 128-sample periodic
    pattern does not apply. iq: [..., T]; nu0/tu: [...], tu in NU_SCALE
    (0.1 Hz) units."""
    den = NU_SCALE * rate
    n = iq.shape[-1]
    nums = nco_numerators(nu0.astype(jnp.int32), tu, n, den, start=1)
    c, s = _num_to_cossin(nums, den)
    on = (tu > 0)[..., None]
    mixed = CF(iq.re * jnp.where(on, c, 1.0),
               iq.im * jnp.where(on, s, 1.0))
    return mixed, _nco_advance(nu0, tu, rate, n)


def _tuner_mix(iq: CF, nu0: jnp.ndarray, tuning: float, rate: int):
    """STATIC-tuning tuner mix (legacy path for sub-0.1 Hz fractional
    tunings): the per-sample numerator ramp is computed host-side in
    float64 — recompiles when the tuning value changes. The carried
    ``nu0`` is in NU_SCALE (0.1 Hz) numerator units like every other
    path; this converts at the boundary."""
    n = iq.shape[-1]
    if tuning <= 0.0:
        # phase never goes positive -> pass-through (:388, :394-396)
        return iq, nu0
    nu_r = nu0.astype(jnp.float32) / np.float32(NU_SCALE)
    ramp = np.mod(np.arange(1, n + 1, dtype=np.float64) * float(tuning),
                  rate).astype(np.float32)
    nums = jnp.mod(nu_r + jnp.asarray(ramp), float(rate))
    idx = (nums * np.float32(SINCOS_SIZE / rate)).astype(jnp.int32) \
        % SINCOS_SIZE
    ang = idx.astype(jnp.float32) * np.float32(TWO_PI / SINCOS_SIZE)
    mixed = CF(iq.re * jnp.cos(ang), iq.im * jnp.sin(ang))
    nu_out = jnp.mod(nu_r + np.float32(np.mod(n * float(tuning), rate)),
                     np.float32(rate))
    return mixed, nu_out * np.float32(NU_SCALE)


def tunings_to_nu(tunings) -> np.ndarray | None:
    """Host Hz values -> exact 0.1 Hz numerator ints, or None when some
    value is not a multiple of 0.1 Hz (the legacy static-ramp path)."""
    t10 = np.asarray(tunings, np.float64).reshape(-1) * NU_SCALE
    r = np.round(t10)
    if not np.allclose(t10, r, atol=1e-6, rtol=0):
        return None
    return np.maximum(r, 0.0).astype(np.int32)


def pattern_mix_ok(tunings, rate: int) -> bool:
    """True when every stream's quantized NCO index sequence is 128-sample
    periodic (the tiled-pattern mix path): tuning a multiple of 0.1 Hz
    with (128 * tu10) % (NU_SCALE * rate) == 0 (for integral tunings
    this is the same classification as the round-3 integral rule)."""
    nu = tunings_to_nu(tunings)
    if nu is None:
        return False
    return all((128 * int(v)) % (NU_SCALE * rate) == 0 for v in nu)


def _vco_mix(ds: CF, vco_idx: jnp.ndarray):
    """bi = i*cos(vco), bq = q*sin(vco) (:515-516); vco phase = pi/4 * m."""
    k = ds.shape[-1]
    m = (vco_idx + jnp.arange(k, dtype=jnp.int32)) % 8
    c = jnp.asarray(_VCO_COS)[m]
    s = jnp.asarray(_VCO_SIN)[m]
    return CF(ds.re * c, ds.im * s), (vco_idx + k) % 8


def _timing_scan(mf: CF, ts: TimingState):
    """Bit-energy timing + differential decision per decimated sample
    (:505-595). mf: [K] planar matched-filter output.

    Returns (valid[K] bool, bit[K] bool, di[K], e2[K], new state).
    """

    def step(s: TimingState, x):
        fi, fq = x
        e1 = fi * fi + fq * fq
        e_ema = s.e_ema.at[s.pos].set(
            s.e_ema[s.pos] * (1.0 - BIT_SMOOTH1) + e1 * BIT_SMOOTH1)
        at_peak = s.pos == s.peak
        di = -(s.last_iq[0] * fi + s.last_iq[1] * fq)
        dq = s.last_iq[0] * fq - s.last_iq[1] * fi
        e2 = jnp.sqrt(di * di + dq * dq)
        new_last = jnp.where(at_peak, jnp.stack([fi, fq]), s.last_iq)
        new_eout = jnp.where(
            at_peak, s.e_out * (1.0 - BIT_SMOOTH2) + e1 * BIT_SMOOTH2, s.e_out)
        valid = at_peak & (e2 > ENERGY_GATE)
        bit = di < 0.0
        # half-bit hand-off of the peak-energy phase (:577-578)
        peak2 = jnp.where(s.pos == (s.peak + 4) % 8, s.new_peak, s.peak)
        # end of bit group: rescan peak energy (:581-592)
        new_new = jnp.where(s.pos == 7,
                            jnp.argmax(e_ema).astype(jnp.int32), s.new_peak)
        ns = TimingState(e_ema, (s.pos + 1) % 8, peak2, new_new,
                         new_eout, new_last)
        return ns, (valid, bit, di, e2)

    new_ts, (valid, bit, di, e2) = lax.scan(step, ts, (mf.re, mf.im))
    return valid, bit, di, e2, new_ts


def _const_ema_trajectory(b: jnp.ndarray, a: float,
                          init: jnp.ndarray, chunk: int = 128) -> jnp.ndarray:
    """Full trajectory of y_g = a*y_{g-1} + b_g (y_{-1} = init) for a
    CONSTANT scalar decay ``a``, computed as chunked triangular matmuls.

    b: [G, P] (P independent lanes); returns [G, P]. Within a length-L
    chunk, local[l] = sum_{j<=l} a^(l-j) b_j is one [L, L] lower-
    triangular contraction; chunk carries compose through a second
    [C, C] triangular matmul; recombination is elementwise. Exact up to
    fp reassociation (decay powers underflow harmlessly for long spans).

    Computed in a transposed [C, P, L] layout so the long group axis is
    the contiguous minor axis under the per-stream vmap (the natural
    [C, L, P] layout would make P = 8 the minor axis).
    """
    g, p = b.shape
    l = min(chunk, max(8, 1 << (g - 1).bit_length())) if g < chunk else chunk
    c = -(-g // l)
    bp = jnp.pad(b, ((0, c * l - g), (0, 0))).reshape(c, l, p)
    bt = jnp.transpose(bp, (0, 2, 1))                      # [C, P, L]
    k = np.arange(l)
    # tri_t[j, l_out] = a^(l_out - j) for j <= l_out
    tri_t = np.where(k[:, None] <= k[None, :],
                     np.power(a, np.maximum(k[None, :] - k[:, None], 0)),
                     0.0).astype(np.float32)
    local = jnp.einsum("cpj,jl->cpl", bt, jnp.asarray(tri_t),
                       precision=lax.Precision.HIGHEST)    # [C, P, L]
    local_end = local[:, :, -1]                            # [C, P]
    cc = np.arange(c)
    dec_l = float(a) ** l
    inter = np.where(cc[:, None] > cc[None, :],
                     np.power(dec_l, np.maximum(cc[:, None] - 1 - cc[None, :],
                                                0)),
                     0.0).astype(np.float32)
    carry_b = jnp.einsum("cd,dp->cp", jnp.asarray(inter), local_end,
                         precision=lax.Precision.HIGHEST)  # [C, P]
    carries = (jnp.asarray(np.power(dec_l, cc).astype(np.float32))[:, None]
               * init[None, :] + carry_b)                  # y_{cL-1}
    pw = jnp.asarray(np.power(a, k + 1).astype(np.float32))
    traj = pw[None, None, :] * carries[:, :, None] + local  # [C, P, L]
    return jnp.transpose(traj, (0, 2, 1)).reshape(c * l, p)[:g]


def _last_valid_prev(vals, on, init):
    """Exclusive last-valid propagation, gather-free.

    prev_t = vals[u] at the largest u < t with on[u] (init where no such
    u); also returns the final inclusive last-valid values (the carried
    state for the next block). Implemented as a log-shift forward fill —
    log2(N) elementwise passes, no gather/scatter.
    """
    n = on.shape[0]
    y = [jnp.where(on, v, jnp.zeros((), v.dtype)) for v in vals]
    filled = on
    s = 1
    while s < n:
        y = [jnp.where(filled, v,
                       jnp.concatenate([jnp.zeros(s, v.dtype), v[:-s]]))
             for v in y]
        filled = filled | jnp.concatenate(
            [jnp.zeros(s, bool), filled[:-s]])
        s *= 2
    prev = [jnp.concatenate([i0[None], jnp.where(filled[:-1], v[:-1], i0)])
            for v, i0 in zip(y, init)]
    fin = [jnp.where(filled[-1], v[-1], i0) for v, i0 in zip(y, init)]
    return prev, fin


def _timing_parallel(mf: CF, ts: TimingState):
    """Fully parallel timing recovery — same decisions as ``_timing_scan``
    without a per-sample recurrence.

    Parallel reformulation of FUNcubeBPSKDemod.java:505-595. Key facts:

    - the bit-phase counter is exactly periodic-8 (see module docstring),
      so samples group into bit periods [G, 8] with in-group position p;
    - each energy-EMA lane is updated exactly once per group, so the 8
      EMAs are independent first-order affine recurrences over groups —
      an ``associative_scan`` (log depth), not a serial scan;
    - within a group, at most two emissions occur: at p = peak0 (if
      peak0 <= h, h = (peak0+4)%8, since the half-bit handoff at h
      happens after the emission check at the same sample) and at
      p = np0 (if np0 > h), where np0 is the argmax published at the end
      of the previous group. peak0(g) = np0(g-1) and np0(g) = A(g-1)
      with A(g) = argmax of the EMAs after group g — all computable in
      parallel once the EMA trajectories are known;
    - the differential decision needs the previous emission's matched
      filter value: a "last-valid" propagation, also associative.

    Returns (valid [2G], bit [2G], di [2G], e2 [2G], new state); the
    two emission slots per group are ordered (p_slot0 <= h < p_slot1).
    """
    k_len = mf.shape[-1]
    assert k_len % SAMPLES_PER_BIT == 0
    g = k_len // SAMPLES_PER_BIT
    fi = mf.re.astype(jnp.float32).reshape(g, SAMPLES_PER_BIT)
    fq = mf.im.astype(jnp.float32).reshape(g, SAMPLES_PER_BIT)
    e1 = fi * fi + fq * fq

    # Lane EMAs over groups: y_g = a*y_{g-1} + b_g with CONSTANT decay a.
    # A generic associative_scan materializes log(G) full-size
    # intermediates; with constant a the prefix is a weighted cumsum, so
    # compute it chunked as triangular matmuls (the linear-RNN-as-
    # matmul trick): within length-L chunks local[l] = sum_{j<=l}
    # a^(l-j) b_j via a lower-triangular [L, L] matrix, then the C chunk
    # carries via one [C, C] triangular matmul, then recombine.
    e_ema_traj = _const_ema_trajectory(
        e1 * BIT_SMOOTH1, 1.0 - BIT_SMOOTH1, ts.e_ema)     # [G, 8]
    a_of_g = jnp.argmax(e_ema_traj, axis=1).astype(jnp.int32)  # first max

    np0 = jnp.concatenate([ts.new_peak[None], a_of_g[:-1]])
    peak0 = jnp.concatenate([ts.peak[None], np0[:-1]])
    h = (peak0 + 4) % 8

    slot_p = jnp.stack([peak0, np0], axis=-1)                  # [G, 2]
    slot_on = jnp.stack([peak0 <= h, np0 > h], axis=-1)        # [G, 2]
    # slot extraction as one-hot masked sums over the 8 in-group
    # positions (a select + reduce, no gather)
    oh = slot_p[:, :, None] == jnp.arange(SAMPLES_PER_BIT)[None, None, :]
    vi = jnp.sum(jnp.where(oh, fi[:, None, :], 0.0), axis=-1).reshape(-1)
    vq = jnp.sum(jnp.where(oh, fq[:, None, :], 0.0), axis=-1).reshape(-1)
    e1_slots = jnp.sum(jnp.where(oh, e1[:, None, :], 0.0), axis=-1).reshape(-1)
    on = slot_on.reshape(-1)

    # previous-valid propagation (exclusive) seeded by the carried
    # dmLastIQ — chunked, gather-free (see _last_valid_prev)
    (prev_i, prev_q), (fin_i, fin_q) = _last_valid_prev(
        (vi, vq), on, (ts.last_iq[0], ts.last_iq[1]))

    di = -(prev_i * vi + prev_q * vq)
    dq = prev_i * vq - prev_q * vi
    e2 = jnp.sqrt(di * di + dq * dq)
    valid = on & (e2 > ENERGY_GATE)
    bit = di < 0.0

    # e_out EMA only at emissions (display diagnostic). Only the FINAL
    # value is needed: y_end = (1-s)^n_on * y0 + sum_t on_t s e1_t
    # (1-s)^(#emissions after t) — a masked weighted sum, no scan at all.
    onf = on.astype(jnp.float32)
    n_on = jnp.sum(onf)
    log_d = np.float32(np.log1p(-BIT_SMOOTH2))
    tail_cnt = n_on - jnp.cumsum(onf)            # emissions strictly after t
    e_out = (jnp.exp(n_on * log_d) * ts.e_out
             + jnp.sum(onf * e1_slots * BIT_SMOOTH2
                       * jnp.exp(tail_cnt * log_d)))

    new_last = jnp.stack([fin_i, fin_q])
    new_ts = TimingState(
        e_ema=e_ema_traj[-1], pos=ts.pos, peak=np0[-1],
        new_peak=a_of_g[-1], e_out=e_out.astype(jnp.float32),
        last_iq=new_last)
    return valid, bit, di, e2, new_ts


def _compact_bits(valid: jnp.ndarray, bit: jnp.ndarray, max_bits: int):
    """Compact valid +-1 bits into a fixed [max_bits] buffer, in order.

    Compaction = ONE sort. (invalid, position, bit) pack into one UNIQUE
    int32 code — invalid flag in the top bit-range sinks invalids to the
    back, the position field keeps valids in arrival order (so no stable
    multi-operand sort machinery is needed), and the bit value rides the
    two low bits. A single-operand non-stable sort measures ~1.4x faster
    than the stable (key, value) sort it replaces, itself ~3x faster
    than an element-serial scatter."""
    n = valid.shape[0]
    assert n < (1 << 28)
    pos = jnp.arange(n, dtype=jnp.int32)
    code = (jnp.where(valid, 0, 1 << 30)
            + (pos << 2)
            + jnp.where(valid, jnp.where(bit, 2, 0), 1))
    scode = lax.sort(code, dimension=0, is_stable=False)
    pm = (scode & 3) - 1                        # 2 -> +1, 0 -> -1, 1 -> 0
    if n >= max_bits:
        out = pm[:max_bits]
    else:
        out = jnp.pad(pm, (0, max_bits - n))
    n_bits = jnp.minimum(jnp.sum(valid.astype(jnp.int32)), max_bits)
    return out.astype(jnp.int8), n_bits


def _first_k_indices(mask: jnp.ndarray, k: int) -> jnp.ndarray:
    """Indices of the first k True entries of mask (-1 padded), without
    jnp.nonzero (whose fixed-size form lowers to an expensive sort)."""
    n = mask.shape[0]
    rank = jnp.cumsum(mask.astype(jnp.int32))            # inclusive
    j = jnp.arange(n, dtype=jnp.int32)
    want = jnp.arange(1, k + 1, dtype=jnp.int32)[:, None]
    cand = jnp.where(mask[None, :] & (rank[None, :] == want), j[None, :], n)
    idx = jnp.min(cand, axis=1)
    return jnp.where(idx < n, idx, -1)


def sync_correlate(window_buf: jnp.ndarray) -> jnp.ndarray:
    """corr_j = sum_n W[j + 80n] * SYNC[n] for every candidate start
    position j (:556-559). window_buf: [5199 + max_bits] of +/-1/0.

    The taps sit at stride 80, so decompose j = 80q + r: with
    WT[r, u] = W[80u + r] (one reshape+transpose), corr[80q + r] =
    sum_n WT[r, q + n] * SYNC[n] — 65 contiguous row slices instead of a
    [max_bits, 65] gather."""
    max_bits = window_buf.shape[-1] - (FEC_BITS - 1)
    length = window_buf.shape[-1]
    u = -(-length // 80)
    w = jnp.pad(window_buf.astype(jnp.float32), (0, 80 * u - length))
    wt = w.reshape(u, 80).T                           # [80, U]
    n_q = -(-max_bits // 80)
    sync = jnp.asarray(_SYNC.astype(np.float32))
    acc = None
    for n in range(65):
        sl = wt[:, n: n + n_q] * sync[n]
        acc = sl if acc is None else acc + sl
    # back to chronological j = 80q + r ordering (sums of +-1 are exact)
    return acc.T.reshape(-1)[:max_bits].astype(jnp.int32)


def _extract_rows(w2: jnp.ndarray, starts: jnp.ndarray, out_len: int):
    """buf[start : start + out_len] for each traced start, gather-free.

    w2: [R, 128] row-major view of the buffer; starts: [H]. Row windows
    are selected with a one-hot row matmul (EXACT in bf16: the buffer
    holds only +-1/0 bit symbols, the one-hot holds 0/1, and the product
    accumulates in f32), then a 7-step log-shift fine roll aligns the
    sub-row offset over only rows_out*128 elements. Replaces a full-
    buffer log2(max_n) roll per window (15 passes over ~29k elements)
    with ~7 passes over ~5.4k — the former was the dominant cost of the
    sync/extract stage."""
    r_rows = w2.shape[0]
    rows_out = -(-out_len // 128) + 1
    q = starts // 128                                     # [H]
    rr = starts % 128
    i = jnp.arange(rows_out, dtype=jnp.int32)
    j = jnp.arange(r_rows, dtype=jnp.int32)
    onehot = (j[None, None, :] == (q[:, None] + i[None, :])[:, :, None])
    sel = jnp.dot(onehot.reshape(-1, r_rows).astype(jnp.bfloat16),
                  w2.astype(jnp.bfloat16),
                  precision=lax.Precision.DEFAULT,
                  preferred_element_type=jnp.float32)     # [H*rows_out, 128]
    flat = sel.reshape(starts.shape[0], rows_out * 128)
    # fine roll left by start % 128: 7 conditional shifts, small array
    for k in range(7):
        s = 1 << k
        rolled = jnp.concatenate([flat[:, s:], flat[:, :s]], axis=1)
        flat = jnp.where(((rr >> k) & 1 == 1)[:, None], rolled, flat)
    return flat[:, :out_len]


def soft_frames_from_bits(bits: jnp.ndarray, n_bits: jnp.ndarray,
                          ring: jnp.ndarray, max_hits: int):
    """Sync-search the bit stream and extract soft FEC windows.

    Returns (windows [max_hits, 5200] uint8, hit_corr [max_hits] i32,
    n_hits, new_ring). Unused window slots are all-0x40 (decode fails
    cleanly).
    """
    w = jnp.concatenate([ring, bits])                 # [5199 + max_bits]
    corr = sync_correlate(w)
    j = jnp.arange(corr.shape[0])
    hits = (corr >= SYNC_THRESHOLD) & (j < n_bits)
    hit_idx = _first_k_indices(hits, max_hits)
    hit_ok = hit_idx >= 0
    w_len = w.shape[0]

    # all window extractions (max_hits frames + the carried ring tail)
    # batch through ONE one-hot row-select matmul
    r_rows = -(-w_len // 128)
    w2 = jnp.pad(w.astype(jnp.float32), (0, r_rows * 128 - w_len)
                 ).reshape(r_rows, 128)
    starts = jnp.concatenate([
        jnp.clip(jnp.where(hit_ok, hit_idx, 0), 0, w_len - FEC_BITS),
        n_bits[None].astype(jnp.int32)])
    ext = _extract_rows(w2, starts, FEC_BITS)
    windows = jnp.where(ext[:max_hits] == 1.0,
                        jnp.uint8(0xC0), jnp.uint8(0x40))
    windows = jnp.where(hit_ok[:, None], windows, jnp.uint8(0x40))
    hit_corr = jnp.where(hit_ok, corr[jnp.where(hit_ok, hit_idx, 0)], 0)
    n_hits = jnp.sum(hit_ok.astype(jnp.int32))
    new_ring = ext[max_hits, :FEC_BITS - 1].astype(jnp.int8)
    return windows, hit_corr, n_hits, new_ring


class BpskBlockOut(NamedTuple):
    windows: jnp.ndarray    # [max_hits, 5200] uint8 soft symbols
    hit_corr: jnp.ndarray   # [max_hits] i32 sync correlation of each hit
    n_hits: jnp.ndarray     # scalar i32
    bits: jnp.ndarray       # [max_bits] i8 +/-1 (0 pad)
    n_bits: jnp.ndarray     # scalar i32
    energies: jnp.ndarray   # [2] f32: last (e1-smooth proxy e_out, max corr)


def _bpsk_post(ds: CF, state: BpskState, tu_phase, ds_tail: CF, ft_state,
               t_len: int, max_hits: int, compat_scan: bool):
    """Per-stream decimated-domain chain: VCO mix -> matched filter ->
    timing recovery -> bit compaction -> sync search. ds: [T//m].

    The named scopes label the layers in profiler traces."""
    with jax.named_scope("vco_mf"):
        bb, vco_idx = _vco_mix(ds, state.vco_idx)
        # compat mode keeps the exact-f32 HIGHEST matched filter (it
        # exists for strict parity work); the fast path uses the
        # 3-product split
        mf, mf_tail = fir_apply_streaming(
            bb, jnp.asarray(DM_FILTER.astype(np.float32)), state.mf_tail,
            precision="highest" if compat_scan else "bf16x3")
    with jax.named_scope("timing"):
        if compat_scan:
            valid, bit, di, e2, timing = _timing_scan(mf, state.timing)
        else:
            valid, bit, di, e2, timing = _timing_parallel(mf, state.timing)
    ds_len = mf.shape[-1]
    max_bits = 2 * (ds_len // SAMPLES_PER_BIT) + 2
    with jax.named_scope("sync"):
        bits, n_bits = _compact_bits(valid, bit, max_bits)
        windows, hit_corr, n_hits, ring = soft_frames_from_bits(
            bits, n_bits, state.ring, max_hits)
    counters = state.counters + jnp.stack(
        [t_len, ds_len, n_bits, n_hits]).astype(jnp.int32)
    out = BpskBlockOut(
        windows=windows, hit_corr=hit_corr, n_hits=n_hits,
        bits=bits, n_bits=n_bits,
        energies=jnp.stack([timing.e_out,
                            jnp.max(hit_corr).astype(jnp.float32)]),
    )
    new_state = BpskState(tu_phase, ds_tail, vco_idx, mf_tail, timing,
                          ring, counters, ft_state)
    return out, new_state


def _bpsk_post_batch(ds: CF, states: BpskState, tu_phase, ds_tail: CF,
                     ft_state, *, t_len: int, max_hits: int,
                     compat_scan: bool):
    """Batched decimated-domain chain: :func:`_bpsk_post` per stream."""
    post = partial(_bpsk_post, t_len=t_len, max_hits=max_hits,
                   compat_scan=compat_scan)
    return jax.vmap(post)(ds, states, tu_phase, ds_tail, ft_state)


def _front_dofft(iq, states: BpskState, track_high, *, rate: int):
    """FFT auto-tune front end (doBufferFFT, :406-464) for all streams;
    track_high is a traced [S] bool (per-instance -upper)."""
    m = rate // DOWN_SAMPLE_RATE
    s, t_len = iq.shape
    samples = rate // 10      # the reference's 0.1 s FFT cadence
    assert t_len % samples == 0, "dofft needs whole 0.1 s sub-blocks"

    def tune1(iq1, ft1, th1):
        mixed, _c, ft = fft_tuner_blocks(
            iq1.reshape(-1, samples), ft1, th1)
        return mixed.reshape(t_len), ft

    mixed, ft_state = jax.vmap(tune1)(iq, states.fft_tuner, track_high)
    ones = jnp.ones((s, 128), jnp.float32)
    ds, ds_tail = mix_decimate(mixed, ones, ones, DS_FILTER, m,
                               states.ds_tail, gain=HOWARD_FUDGE_FACTOR)
    return ds, ds_tail, states.tu_phase, ft_state


def _front_manual(iq, states: BpskState, tunings, *, rate: int,
                  manual_mode: str, static_tunings):
    """Manual-tune front end (RxMixTuner + decimator, :366-397, 466-492)."""
    m = rate // DOWN_SAMPLE_RATE
    s, t_len = iq.shape
    taps = DS_FILTER.astype(np.float32)
    if manual_mode == "pattern":
        # the quantized NCO index sequence repeats every 128 samples:
        # mix by a tiled [S, 128] table instead of per-sample numerators
        cos_pat, sin_pat = _nco_pattern(states.tu_phase, tunings, rate)
        tu_phase = _nco_advance(states.tu_phase, tunings, rate, t_len)
        ds, ds_tail = mix_decimate(iq, cos_pat, sin_pat, taps, m,
                                   states.ds_tail, gain=HOWARD_FUDGE_FACTOR)
    elif manual_mode == "general":
        # any integral tuning: exact-numerator full-length mix
        mixed, tu_phase = _tuner_full_mix(iq, states.tu_phase, tunings, rate)
        ds, ds_tail = polyphase_decimate(mixed, jnp.asarray(taps), m,
                                         tail=states.ds_tail,
                                         gain=HOWARD_FUDGE_FACTOR)
    else:
        # sub-0.1 Hz tunings: STATIC per-stream host-f64 ramps (legacy)
        assert manual_mode == "static" and len(static_tunings) == s
        outs = []
        for i, tun in enumerate(static_tunings):
            mixed1, ph1 = _tuner_mix(iq[i], states.tu_phase[i], tun, rate)
            ds1, tl1 = polyphase_decimate(mixed1, jnp.asarray(taps), m,
                                          tail=states.ds_tail[i],
                                          gain=HOWARD_FUDGE_FACTOR)
            outs.append((ds1, ph1, tl1))
        ds = CF(jnp.stack([o[0].re for o in outs]),
                jnp.stack([o[0].im for o in outs]))
        tu_phase = jnp.stack([o[1] for o in outs])
        ds_tail = CF(jnp.stack([o[2].re for o in outs]),
                     jnp.stack([o[2].im for o in outs]))
    return ds, ds_tail, tu_phase, states.fft_tuner


def _front_dispatch(iq, states: BpskState, tunings, dofft, track_high, *,
                    rate: int, mix_mode: str, static_tunings):
    """Select and run the full-rate front end(s) for a batch: manual
    NCO mix (pattern/general/static), FFT auto-tune (dofft), or both
    with per-stream selection (``mixed:<manual_mode>``). Shared by the
    single-device batch and the pipeline's stage 0. Returns
    (ds, ds_tail, tu_phase, ft_state) with ds the decimated stream."""
    s = iq.shape[0]
    if mix_mode == "dofft":
        return _front_dofft(iq, states, track_high, rate=rate)
    if mix_mode.startswith("mixed:"):
        manual_mode = mix_mode[len("mixed:"):]
        x_f, tail_f, _ph_f, ft_f = _front_dofft(iq, states, track_high,
                                                rate=rate)
        x_m, tail_m, ph_m, _ft_m = _front_manual(
            iq, states, tunings, rate=rate, manual_mode=manual_mode,
            static_tunings=static_tunings)
        sel = lambda a, b: jnp.where(
            dofft.reshape((s,) + (1,) * (a.ndim - 1)), a, b)
        x = CF(sel(x_f.re, x_m.re), sel(x_f.im, x_m.im))
        ds_tail = CF(sel(tail_f.re, tail_m.re), sel(tail_f.im, tail_m.im))
        tu_phase = jnp.where(dofft, states.tu_phase, ph_m)
        ft_state = jax.tree.map(sel, ft_f, states.fft_tuner)
        return x, ds_tail, tu_phase, ft_state
    return _front_manual(iq, states, tunings, rate=rate,
                         manual_mode=mix_mode, static_tunings=static_tunings)


@partial(jax.jit, static_argnames=("rate", "mix_mode", "static_tunings",
                                   "max_hits", "compat_scan"))
def _bpsk_block_batched(iq, states: BpskState, tunings, dofft, track_high,
                        *, rate: int, mix_mode: str, static_tunings,
                        max_hits: int, compat_scan: bool
                        ) -> Tuple[BpskBlockOut, BpskState]:
    """Batched telemetry chain over [S, T] stream rows with per-stream
    TRACED tunings [S] int32 (the N-tab analog, jsdr.java:479-484) and
    per-stream TRACED dofft/track_high [S] bool (the per-tab
    FUNcube<n>-bpsk-dofft / -upper keys, FUNcubeBPSKDemod.java:97-99).

    The full-rate front end (tuner mix + decimating FIR) mixes by a
    tiled 128-sample pattern whenever every stream's quantized NCO ramp
    is 128-sample periodic (manual mode "pattern"); otherwise the mix
    is a full-length exact-numerator elementwise pass ("general").
    ``mix_mode`` is "dofft" (all streams auto-tune), a manual mode
    (no stream auto-tunes), or "mixed:<manual_mode>" — both front ends
    run and each stream selects per its dofft flag (costs one extra
    front-end pass, only for heterogeneous instance sets). The
    decimated-domain stages are vmapped."""
    s, t_len = iq.shape
    m = rate // DOWN_SAMPLE_RATE
    assert t_len % (8 * m) == 0, (
        f"block length {t_len} must be a multiple of 8*decim = {8 * m} "
        "(timing recovery groups the decimated stream into whole "
        "8-sample bit periods)")
    with jax.named_scope("mix_decimate"):
        ds, ds_tail, tu_phase, ft_state = _front_dispatch(
            iq, states, tunings, dofft, track_high, rate=rate,
            mix_mode=mix_mode, static_tunings=static_tunings)
    return _bpsk_post_batch(ds, states, tu_phase, ds_tail, ft_state,
                            t_len=t_len, max_hits=max_hits,
                            compat_scan=compat_scan)


def bpsk_block(iq, cfg: BpskConfig, state: BpskState,
               tuning=None) -> Tuple[BpskBlockOut, BpskState]:
    """Process one block [T] through the full telemetry chain.

    ``iq``: CF planar pair (or host numpy complex64, split on host). T
    must be a multiple of 8*cfg.decim (the timing recovery groups the
    decimated stream into whole 8-sample bit periods — see
    ``_timing_parallel``; at 96 kS/s that is a multiple of 80). Returns
    extracted soft FEC windows (feed to jsdr_tpu.fec.decoder.fec_decode)
    and the carried state.
    """
    iq = as_cf(iq)
    states = jax.tree.map(lambda x: x[None], state)
    tunings = None if tuning is None else np.asarray([tuning])
    out, new_states = bpsk_block_batch(CF(iq.re[None], iq.im[None]),
                                       cfg, states, tunings)
    take0 = lambda x: x[0]
    return jax.tree.map(take0, out), jax.tree.map(take0, new_states)


def bpsk_block_batch_spectrum(iq, cfg: BpskConfig, states: BpskState,
                              tunings=None, window: bool = True):
    """Batched telemetry chain PLUS the display spectrum of every stream
    in one step: the flagship per-step call of a deployment that renders
    a waterfall while decoding (the reference runs fft.java and
    FUNcubeBPSKDemod.java side by side on every block).

    The spectrum takes n = rate/10 sample blocks (T % n == 0), see
    :func:`jsdr_tpu.ops.spectrum.spectrum_waterfall`. Returns
    (WaterfallOut, BpskBlockOut, new_states)."""
    iq = as_cf(iq)
    spec = spectrum_waterfall(iq, cfg.rate // 10, cfg.rate, window=window)
    out, new_states = bpsk_block_batch(iq, cfg, states, tunings)
    return spec, out, new_states


def bpsk_init_batch(cfg: BpskConfig, n_streams: int) -> BpskState:
    """Stacked state for a batch of independent streams (the analog of N
    FUNcubeBPSKDemod tabs, jsdr.java:479-483)."""
    one = bpsk_init(cfg)
    return jax.tree.map(
        lambda x: np.broadcast_to(x, (n_streams, *x.shape)).copy(), one)


def bpsk_block_batch(iq, cfg: BpskConfig, states: BpskState, tunings=None,
                     dofft=None,
                     track_high=None) -> Tuple[BpskBlockOut, BpskState]:
    """Batched telemetry chain over independent streams: [S, T] blocks.

    ``tunings``: host array-like [S] of per-stream NCO Hz (defaults to
    cfg.tuning for every stream) — the analog of N FUNcubeBPSKDemod tabs
    each with its own FUNcube<n>-bpsk-tuning (jsdr.java:479-484,
    FUNcubeBPSKDemod.java:195-196). Any tuning that is a multiple of
    0.1 Hz is traced data (exact 0.1 Hz-unit integer numerators):
    retuning between calls does NOT recompile. The host owns this array;
    pass plain numpy/ints.

    ``dofft`` / ``track_high``: host bool array-likes [S] — per-instance
    FUNcube<n>-bpsk-dofft / -upper (FUNcubeBPSKDemod.java:97-99); default
    to cfg.dofft / cfg.track_high for every stream. A heterogeneous
    dofft set runs BOTH front ends and selects per stream (one compile,
    one extra front-end pass); toggling values never recompiles within
    the same all-manual / all-auto / mixed class.
    """
    if cfg.compat_scan and jax.devices()[0].platform != "cpu":
        # the per-sample lax.scan runs 9600 dependent steps per decimated
        # second; it exists for fp-order parity verification, which the
        # CPU runs fine
        import warnings
        warnings.warn(
            "compat_scan=True compiles the per-sample timing scan (one "
            "sequential step per decimated sample) on an accelerator, "
            "where it is far slower than the default parallel timing "
            "recovery. Use compat_scan only for fp-order parity checks, "
            "ideally on CPU.", RuntimeWarning, stacklevel=2)
    iq = as_cf(iq)
    s = iq.shape[0]
    if tunings is None:
        tunings = np.full(s, cfg.tuning, np.float64)
    tun_np = np.asarray(tunings, np.float64).reshape(-1)
    assert tun_np.shape[0] == s, (tun_np.shape, s)
    dofft_np = np.broadcast_to(
        np.asarray(cfg.dofft if dofft is None else dofft, bool), (s,)).copy()
    th_np = np.broadcast_to(
        np.asarray(cfg.track_high if track_high is None else track_high,
                   bool), (s,)).copy()
    static_tunings = None
    nu = tunings_to_nu(tun_np)
    if nu is not None:
        # any multiple of 0.1 Hz rides the exact int-numerator path:
        # traced data, never recompiles (round 3 supported integral
        # tunings only; the reference key is integral, jsdr.java:87-95)
        manual_mode = "pattern" if pattern_mix_ok(tun_np, cfg.rate) \
            else "general"
        tun_arr = nu
    else:
        # sub-0.1 Hz fractional tunings take the legacy host-ramp path
        # whose ramps are baked into the compilation — make the
        # per-tuning-set recompile visible instead of silently eating a
        # compile each time
        import warnings
        warnings.warn(
            f"tunings {tun_np.tolist()} are not multiples of 0.1 Hz and "
            "use the static mix path: every distinct tuning set triggers "
            "a recompilation (0.1 Hz-multiple tunings are traced data "
            "and never recompile)",
            RuntimeWarning, stacklevel=2)
        manual_mode = "static"
        static_tunings = tuple(float(t) for t in tun_np)
        tun_arr = np.zeros(s, np.int32)
    if dofft_np.all():
        mix_mode = "dofft"
    elif dofft_np.any():
        mix_mode = f"mixed:{manual_mode}"
    else:
        mix_mode = manual_mode
    return _bpsk_block_batched(
        iq, states, tun_arr, dofft_np, th_np, rate=cfg.rate,
        mix_mode=mix_mode, static_tunings=static_tunings,
        max_hits=cfg.max_hits_per_block, compat_scan=cfg.compat_scan)
