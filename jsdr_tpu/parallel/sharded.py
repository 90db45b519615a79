"""Sharded telemetry pipeline: the multi-chip "training step" of the
framework.

Sharding layout over a ("dp", "sp") mesh:

- streams (batch) partitioned over dp — N independent demod instances,
  each with its own traced tuning and dofft/track_high flags
  (jsdr.java:479-484, FUNcubeBPSKDemod.java:97-99)
- each stream's time axis partitioned over sp

**Front end** (full-rate): manual streams mix with the exact
int-numerator NCO at their global sample offsets; auto-tune (dofft)
streams run the doBufferFFT front end (FUNcubeBPSKDemod.java:406-464)
with the per-0.1 s FFT/peak analysis fully parallel per shard and ONLY
the 3-scalar tuner EMA recurrence relayed across shards (n_sp-1
ppermute rounds of a tiny state — the FFTs never re-run). The
decimating FIR's 26-sample halo rides the device ring as MIXED-domain
samples (one ppermute): both front ends produce their feed locally, so
one halo exchange serves manual, auto and mixed batches alike; shard
0's halo is the CARRIED mixed-domain tail, so consecutive sharded
steps chain bit-exactly with ``bpsk_block_batch`` and frames straddling
step boundaries are found.

**Decode tail** (9600 Hz): sharded over sp as well (round 3 replicated
it on every rank — 47 % weak-scaling efficiency at sp=4; see PERF.md).
Every stage's cross-shard dependence is a tiny carried state:

- VCO mix: phase is exactly (pi/4)*(global index) — position-exact per
  shard, no communication;
- 65-tap matched filter: 64-sample mixed-domain ring halo (ppermute);
- bit-timing EMA: the constant-decay recurrence is affine, so each
  shard computes its zero-init local trajectory and the boundary
  values resolve in closed form from one all_gather of [8]-vectors
  (ema_in_k = a^(G_loc*k) ema_0 + sum_j<k a^(G_loc*(k-1-j)) b_end_j);
- peak schedule: np0/peak0 of a shard's first groups are the argmax of
  the left neighbor's last two groups — one ppermute of 2 scalars;
- the differential decoder's last-valid chain: local log-shift fill,
  then the boundary emission (i, q) resolves from one all_gather of 3
  scalars per shard;
- e_out: emission-count-weighted suffix algebra composes exactly from
  per-shard (count, contribution) pairs (all_gather of 2 scalars);
- sync search: the compacted +-1 bit stream is TINY (2 bits per
  decimated 8-sample group, ~12 kb/s of stream), so (valid, bit) planes
  all_gather along sp and every rank compacts the full stream (one
  sort); the stride-80 sync correlation and window extraction are then
  SHARDED by candidate position — rank k correlates/extracts only
  start positions in its 1/n_sp slice, and the per-rank hits merge
  position-ordered with one all_gather (first max_hits win, matching
  the single-device scan order).

Every carried quantity lands back in the SAME BpskState pytree, so the
sharded step chains bit-exactly with the single-device
``bpsk_block_batch`` and with itself across segment boundaries
(tests/test_parallel.py asserts equality of bits, frames and state at
96 k and 192 k, plus a randomized property test). Two bounded fp
caveats on the carried STATE: the EMA/e_out carries compose in a
different (documented) order, and on CPU backends XLA's dot blocking
depends on operand shape, so the per-shard conv tails can differ from
the single-device ones by ulps (GPU libraries also pick dot algorithms
per shape, so the same holds there). One decision-level exposure follows from the
first caveat: the peak schedule takes argmax over the fp-reassociated
EMA trajectory (traj0 + a^k*ema_in), so an exact tie-or-ulp near-tie
between two lane energies could pick a different peak phase than the
single-device composition and shift a bit-emission slot. The equality
tests above (including the randomized property test) cover it
empirically — no divergence observed — but it is not excluded by
construction.

``compat_scan=True`` (the per-sample fp-order parity mode) keeps the
round-3 replicated tail: the sequential scan cannot shard over time.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..demod import bpsk as B
from ..demod.fft_tuner import (FftTunerState, tuner_emit, tuner_precompute,
                               tuner_recurrence)
from ..ops.cplx import CF, as_cf
from ..ops.fir import fir_apply_streaming, polyphase_decimate
from ..ops.spectrum import spectrum_block


def _psum_from_last(x, n_sp: int):
    """Replicate the LAST sp rank's value to every rank (one psum)."""
    last = (lax.axis_index("sp") == n_sp - 1)
    if x.dtype in (jnp.int32, jnp.int8):
        return lax.psum(jnp.where(last, x, 0), "sp")
    return lax.psum(jnp.where(last, x, jnp.zeros((), x.dtype)), "sp")


def _front_manual_local(iq_loc: CF, nu0, tu, *, rate: int):
    """Exact-numerator NCO mix of this shard's samples at their GLOBAL
    offsets (RxMixTuner at scale, FUNcubeBPSKDemod.java:382-397).
    Returns the mixed feed [s_loc, t_loc]."""
    t_loc = iq_loc.shape[-1]
    den = B.NU_SCALE * rate          # numerators in 0.1 Hz units
    sp_idx = lax.axis_index("sp")
    g0 = (sp_idx.astype(jnp.int32) * np.int32(t_loc % den)) % den
    nu_shard = (nu0.astype(jnp.int32)
                + B._modmul_traced(tu, g0, den)) % den
    nums = B.nco_numerators(nu_shard, tu, t_loc, den, start=1)
    c, s = B._num_to_cossin(nums, den)
    on = (tu > 0)[..., None]
    return CF(iq_loc.re * jnp.where(on, c, 1.0),
              iq_loc.im * jnp.where(on, s, 1.0))


def _front_dofft_local(iq_loc: CF, ft0: FftTunerState, track_high, *,
                       rate: int, n_sp: int):
    """doBufferFFT front end per time shard: per-block FFT/peak analysis
    local and parallel; the 3-scalar tuner EMA recurrence relays across
    shards (n_sp-1 tiny ppermute rounds), then slices/inverse FFTs
    emit locally. Returns (feed [s_loc, t_loc], final FftTunerState of
    THIS shard — the last shard's is the carried one)."""
    s_loc, t_loc = iq_loc.shape
    samples = rate // 10
    assert t_loc % samples == 0, (
        "dofft sharding needs whole 0.1 s blocks per shard")
    nb_loc = t_loc // samples
    blocks = CF(iq_loc.re.reshape(s_loc, nb_loc, samples),
                iq_loc.im.reshape(s_loc, nb_loc, samples))
    spec, ave, bin_pos, max_bin, end = tuner_precompute(
        blocks, jnp.asarray(track_high)[:, None])
    end1 = end[:, 0]

    rec = jax.vmap(tuner_recurrence)
    sp_idx = lax.axis_index("sp")
    st_in = ft0                       # correct on rank 0 only; relay fixes
    if n_sp > 1:
        perm = [(i, i + 1) for i in range(n_sp - 1)]
        for r in range(n_sp - 1):
            st_out, _ = rec(st_in, ave, bin_pos, max_bin, end1)
            inc = jax.tree.map(lambda x: lax.ppermute(x, "sp", perm), st_out)
            st_in = jax.tree.map(
                lambda cur, i_: jnp.where(sp_idx == r + 1, i_, cur),
                st_in, inc)
    st_fin, centres = rec(st_in, ave, bin_pos, max_bin, end1)
    feed = jax.vmap(tuner_emit)(spec, centres)
    return CF(feed.re.reshape(s_loc, t_loc),
              feed.im.reshape(s_loc, t_loc)), st_fin


def _decimate_with_halo(feed: CF, ds_tail: CF, *, m: int, n_sp: int):
    """Decimating 27-tap FIR over the sharded mixed-domain feed: the
    26-sample halo hops the device ring; shard 0 uses the CARRIED tail.
    Returns (ds_loc, new carried ds_tail — replicated to all ranks)."""
    n_tail = len(B.DS_FILTER) - 1
    sp_idx = lax.axis_index("sp")
    perm = [(i, (i + 1) % n_sp) for i in range(n_sp)]
    halo = CF(lax.ppermute(feed.re[..., -n_tail:], "sp", perm),
              lax.ppermute(feed.im[..., -n_tail:], "sp", perm))
    is0 = sp_idx == 0
    pre = CF(jnp.where(is0, ds_tail.re, halo.re),
             jnp.where(is0, ds_tail.im, halo.im))
    ds_loc, _ = polyphase_decimate(
        feed, jnp.asarray(B.DS_FILTER.astype(np.float32)), m,
        tail=pre, gain=B.HOWARD_FUDGE_FACTOR)
    new_tail = CF(_psum_from_last(feed.re[..., -n_tail:], n_sp),
                  _psum_from_last(feed.im[..., -n_tail:], n_sp))
    return ds_loc, new_tail


def _fill_batched(vi, vq, on):
    """Batched log-shift last-valid fill along the last axis (the
    batched form of demod.bpsk._last_valid_prev's core). Returns
    (yi, yq, filled) — inclusive fill with NO seed applied."""
    n = on.shape[-1]
    yi = jnp.where(on, vi, 0.0)
    yq = jnp.where(on, vq, 0.0)
    filled = on
    s = 1
    while s < n:
        shift = lambda a, fill: jnp.concatenate(
            [jnp.full((*a.shape[:-1], s), fill, a.dtype), a[..., :-s]],
            axis=-1)
        yi = jnp.where(filled, yi, shift(yi, 0.0))
        yq = jnp.where(filled, yq, shift(yq, 0.0))
        filled = filled | shift(filled, False)
        s *= 2
    return yi, yq, filled


def _sync_correlate_slice(w: jnp.ndarray, q0, n_q: int):
    """Sync correlation for candidate start positions j in
    [80*q0, 80*(q0+n_q)) only — the per-shard slice of
    demod.bpsk.sync_correlate's stride-80 decomposition (q0 traced).
    w must be padded so its [80, U] view has U >= q0 + n_q + 65."""
    length = w.shape[-1]
    u = length // 80
    wt = w.astype(jnp.float32).reshape(u, 80).T          # [80, U]
    wts = lax.dynamic_slice(wt, (0, q0), (80, n_q + 65))
    sync = jnp.asarray(B._SYNC.astype(np.float32))
    acc = None
    for n in range(65):
        sl = wts[:, n: n + n_q] * sync[n]
        acc = sl if acc is None else acc + sl
    return acc.T.reshape(-1).astype(jnp.int32)           # [80*n_q]


def _place_segments(bits_g: jnp.ndarray, n_g: jnp.ndarray,
                    max_bits: int) -> jnp.ndarray:
    """Assemble the global compacted bit stream from per-rank compacted
    segments without a global sort.

    bits_g: [n_sp, s_loc, mb_loc] i8 (+1/-1, 0 pad), n_g: [n_sp, s_loc]
    valid counts. Segment j lands at offset off_j = sum_{i<j} n_i.
    Placement at a traced offset o = 128*Q + R is a 7-step log fine-roll
    (by R) plus a one-hot row matmul (by Q) — the inverse of
    demod.bpsk._extract_rows, exact in bf16 for +-1/0 values. Returns
    [s_loc, max_bits] i8, zero-padded past the total count (identical
    to the single-device compaction of the full stream)."""
    n_sp, s_loc, mb_loc = bits_g.shape
    q_in = -(-mb_loc // 128) + 1                 # +1 row of roll spill
    out_rows = -(-max_bits // 128)
    if n_sp == 1:
        seg = bits_g[0]
        return jnp.pad(seg, ((0, 0), (0, max_bits - mb_loc))) \
            if max_bits >= mb_loc else seg[:, :max_bits]
    off = jnp.concatenate(
        [jnp.zeros((1, s_loc), n_g.dtype), jnp.cumsum(n_g[:-1], axis=0)])
    t_idx = jnp.arange(out_rows * 128, dtype=jnp.int32)
    acc = jnp.zeros((s_loc, out_rows * 128), jnp.float32)
    rows_o = jnp.arange(out_rows, dtype=jnp.int32)[None, :, None]
    rows_i = jnp.arange(q_in, dtype=jnp.int32)[None, None, :]
    for j in range(n_sp):
        seg = jnp.pad(bits_g[j].astype(jnp.float32),
                      ((0, 0), (0, q_in * 128 - mb_loc)))
        o = off[j].astype(jnp.int32)             # [s_loc]
        r, q = o % 128, o // 128
        x = seg
        for kbit in range(7):
            s_ = 1 << kbit
            shifted = jnp.concatenate(
                [jnp.zeros((s_loc, s_), x.dtype), x[:, :-s_]], axis=1)
            x = jnp.where(((r >> kbit) & 1 == 1)[:, None], shifted, x)
        x3 = x.reshape(s_loc, q_in, 128)
        oh = (rows_o == rows_i + q[:, None, None])
        placed = lax.dot_general(
            oh.astype(jnp.bfloat16), x3.astype(jnp.bfloat16),
            (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)  # [s_loc, out_rows, 128]
        placed = placed.reshape(s_loc, out_rows * 128)
        live = ((t_idx[None, :] >= o[:, None])
                & (t_idx[None, :] < (o + n_g[j])[:, None]))
        acc = acc + jnp.where(live, placed, 0.0)
    return acc[:, :max_bits].astype(jnp.int8)


def _tail_sharded(ds_loc: CF, states: B.BpskState, tu_phase, ds_tail: CF,
                  ft_state, *, rate: int, n_sp: int, max_hits: int,
                  t_total: int):
    """sp-sharded decode tail (FUNcubeBPSKDemod.java:505-595 +
    sync/extract at scale). ds_loc: [s_loc, t_ds_loc]. All outputs and
    carried state are replicated across sp by construction."""
    p = B.SAMPLES_PER_BIT
    s_loc, t_ds_loc = ds_loc.shape
    assert t_ds_loc % p == 0
    g_loc = t_ds_loc // p
    assert g_loc >= 2, "sharded tail needs >= 2 bit groups per shard"
    t_ds_total = t_ds_loc * n_sp
    sp_idx = lax.axis_index("sp")

    # ---- VCO mix at exact global positions -------------------------------
    vco0 = (states.vco_idx + sp_idx * (t_ds_loc % 8)) % 8        # [s_loc]
    bb, _ = jax.vmap(B._vco_mix)(ds_loc, vco0)
    vco_out = (states.vco_idx + (t_ds_total % 8)) % 8

    # ---- matched filter with 64-sample ring halo -------------------------
    n_mf = len(B.DM_FILTER) - 1
    perm = [(i, (i + 1) % n_sp) for i in range(n_sp)]
    halo = CF(lax.ppermute(bb.re[..., -n_mf:], "sp", perm),
              lax.ppermute(bb.im[..., -n_mf:], "sp", perm))
    is0 = sp_idx == 0
    mf_pre = CF(jnp.where(is0, states.mf_tail.re, halo.re),
                jnp.where(is0, states.mf_tail.im, halo.im))
    mf, _ = fir_apply_streaming(
        bb, jnp.asarray(B.DM_FILTER.astype(np.float32)), mf_pre,
        precision="bf16x3")
    mf_tail_out = CF(_psum_from_last(bb.re[..., -n_mf:], n_sp),
                     _psum_from_last(bb.im[..., -n_mf:], n_sp))

    # ---- bit-energy EMA: affine cross-shard resolution -------------------
    fi = mf.re.astype(jnp.float32).reshape(s_loc, g_loc, p)
    fq = mf.im.astype(jnp.float32).reshape(s_loc, g_loc, p)
    e1 = fi * fi + fq * fq
    a = 1.0 - B.BIT_SMOOTH1
    zero8 = jnp.zeros((s_loc, p), jnp.float32)
    traj0 = jax.vmap(
        lambda b1, i1: B._const_ema_trajectory(b1, a, i1))(
        e1 * B.BIT_SMOOTH1, zero8)                       # [s_loc, G, 8]
    b_end = traj0[:, -1]                                 # [s_loc, 8]
    b_ends = lax.all_gather(b_end, "sp")                 # [n_sp, s_loc, 8]
    pw_tbl = jnp.asarray(
        np.power(a, g_loc * np.arange(n_sp + 1)).astype(np.float32))
    k = sp_idx
    ema_in = pw_tbl[k] * states.timing.e_ema
    for j in range(n_sp - 1):                            # j < k contributes
        wgt = jnp.where(j < k, pw_tbl[jnp.clip(k - 1 - j, 0, n_sp)], 0.0)
        ema_in = ema_in + wgt * b_ends[j]
    pw_g = jnp.asarray(
        np.power(a, np.arange(1, g_loc + 1)).astype(np.float32))
    traj = traj0 + pw_g[None, :, None] * ema_in[:, None, :]
    e_ema_out = _psum_from_last(traj[:, -1], n_sp)

    # ---- peak schedule with a 2-scalar left-boundary hop -----------------
    am = jnp.argmax(traj, axis=2).astype(jnp.int32)      # [s_loc, G]
    send = jnp.stack([am[:, -1], am[:, -2]], axis=-1)
    recv = lax.ppermute(send, "sp", perm)
    in_np = jnp.where(is0, states.timing.new_peak, recv[:, 0])
    in_pk = jnp.where(is0, states.timing.peak, recv[:, 1])
    np0 = jnp.concatenate([in_np[:, None], am[:, :-1]], axis=1)
    peak0 = jnp.concatenate([in_pk[:, None], np0[:, :-1]], axis=1)
    h = (peak0 + 4) % 8
    peak_out = _psum_from_last(np0[:, -1], n_sp)
    new_peak_out = _psum_from_last(am[:, -1], n_sp)

    # ---- slot extraction (one-hot over the 8 phases) ---------------------
    slot_p = jnp.stack([peak0, np0], axis=-1)            # [s_loc, G, 2]
    slot_on = jnp.stack([peak0 <= h, np0 > h], axis=-1)
    oh = slot_p[..., None] == jnp.arange(p)[None, None, None, :]
    vi = jnp.sum(jnp.where(oh, fi[:, :, None, :], 0.0), axis=-1)
    vq = jnp.sum(jnp.where(oh, fq[:, :, None, :], 0.0), axis=-1)
    e1s = jnp.sum(jnp.where(oh, e1[:, :, None, :], 0.0), axis=-1)
    n2 = 2 * g_loc
    vi, vq, e1s = (x.reshape(s_loc, n2) for x in (vi, vq, e1s))
    on = slot_on.reshape(s_loc, n2)

    # ---- last-valid chain: local fill + 3-scalar boundary resolution -----
    yi, yq, filled = _fill_batched(vi, vq, on)
    lv = jnp.stack([yi[:, -1], yq[:, -1],
                    filled[:, -1].astype(jnp.float32)], axis=-1)
    lvg = lax.all_gather(lv, "sp")                       # [n_sp, s_loc, 3]
    ci, cq = states.timing.last_iq[:, 0], states.timing.last_iq[:, 1]
    gi, gq = ci, cq
    for j in range(n_sp):
        has_j = lvg[j, :, 2] > 0.5
        take = (j < k) & has_j
        ci = jnp.where(take, lvg[j, :, 0], ci)
        cq = jnp.where(take, lvg[j, :, 1], cq)
        gi = jnp.where(has_j, lvg[j, :, 0], gi)          # global final
        gq = jnp.where(has_j, lvg[j, :, 1], gq)
    prev_i = jnp.concatenate(
        [ci[:, None], jnp.where(filled[:, :-1], yi[:, :-1], ci[:, None])],
        axis=1)
    prev_q = jnp.concatenate(
        [cq[:, None], jnp.where(filled[:, :-1], yq[:, :-1], cq[:, None])],
        axis=1)
    last_iq_out = jnp.stack([gi, gq], axis=1)

    di = -(prev_i * vi + prev_q * vq)
    dq = prev_i * vq - prev_q * vi
    e2 = jnp.sqrt(di * di + dq * dq)
    valid = on & (e2 > B.ENERGY_GATE)
    bit = di < 0.0

    # ---- e_out: exact suffix-weighted composition ------------------------
    onf = on.astype(jnp.float32)
    cnt = jnp.sum(onf, axis=-1)
    log_d = np.float32(np.log1p(-B.BIT_SMOOTH2))
    tail_cnt = cnt[:, None] - jnp.cumsum(onf, axis=-1)
    contrib = jnp.sum(onf * e1s * B.BIT_SMOOTH2
                      * jnp.exp(tail_cnt * log_d), axis=-1)
    cc = lax.all_gather(jnp.stack([cnt, contrib], axis=-1),
                        "sp")                            # [n_sp, s_loc, 2]
    total = jnp.sum(cc[:, :, 0], axis=0)
    e_out = jnp.exp(total * log_d) * states.timing.e_out
    after = total
    for j in range(n_sp):
        after = after - cc[j, :, 0]                      # emissions after j
        e_out = e_out + cc[j, :, 1] * jnp.exp(after * log_d)
    timing_out = B.TimingState(
        e_ema=e_ema_out, pos=states.timing.pos, peak=peak_out,
        new_peak=new_peak_out, e_out=e_out.astype(jnp.float32),
        last_iq=last_iq_out)

    # ---- bit stream: compact LOCALLY (each rank sorts only its own 1/sp
    # of the slots — the sort is the only tail stage whose cost grows
    # with the gathered length), gather the compacted i8 segments (half
    # the bytes of raw decision planes), and PLACE them at their global
    # offsets: concatenated local compactions ARE the globally sorted
    # stream, so assembly is a per-segment fine roll + one-hot row
    # matmul, no global sort
    mb_loc = 2 * g_loc + 2
    bits_loc, n_loc = jax.vmap(
        partial(B._compact_bits, max_bits=mb_loc))(valid, bit)
    bits_g = lax.all_gather(bits_loc, "sp")          # [n_sp, s_loc, mb]
    n_g = lax.all_gather(n_loc, "sp")                # [n_sp, s_loc]
    max_bits = 2 * (t_ds_total // p) + 2
    bits = _place_segments(bits_g, n_g, max_bits)
    n_bits = jnp.sum(n_g, axis=0)

    # ---- sync search sharded by candidate position -----------------------
    q_per = -(-max_bits // (80 * n_sp))
    q0 = sp_idx * q_per
    w_len = B.FEC_BITS - 1 + max_bits
    pad_cols = max(-(-w_len // 80), n_sp * q_per + 65)

    def search1(bits1, n_bits1, ring1):
        w = jnp.concatenate([ring1, bits1])
        wp = jnp.pad(w, (0, 80 * pad_cols - w_len))
        corr = _sync_correlate_slice(wp, q0, q_per)
        j_g = 80 * q0 + jnp.arange(80 * q_per, dtype=jnp.int32)
        hits = (corr >= B.SYNC_THRESHOLD) & (j_g < n_bits1)
        idx_loc = B._first_k_indices(hits, max_hits)
        ok = idx_loc >= 0
        pos = jnp.where(ok, 80 * q0 + idx_loc, -1)
        corr_sel = jnp.where(ok, corr[jnp.where(ok, idx_loc, 0)], 0)
        r_rows = -(-w_len // 128)
        w2 = jnp.pad(w.astype(jnp.float32),
                     (0, r_rows * 128 - w_len)).reshape(r_rows, 128)
        starts = jnp.concatenate([
            jnp.clip(jnp.where(ok, pos, 0), 0, w_len - B.FEC_BITS),
            n_bits1[None].astype(jnp.int32)])
        ext = B._extract_rows(w2, starts, B.FEC_BITS)
        win = jnp.where(ext[:max_hits] == 1.0, jnp.uint8(0xC0),
                        jnp.uint8(0x40))
        win = jnp.where(ok[:, None], win, jnp.uint8(0x40))
        ring_new = ext[max_hits, :B.FEC_BITS - 1].astype(jnp.int8)
        return win, corr_sel, pos, ring_new

    win_l, corr_l, pos_l, ring_new = jax.vmap(search1)(
        bits, n_bits, states.ring)

    # merge the per-rank hits (position-ordered: rank-major IS ascending)
    pos_g = lax.all_gather(pos_l, "sp")                  # [n_sp, s_loc, H]
    corr_g = lax.all_gather(corr_l, "sp")
    win_g = lax.all_gather(win_l, "sp")                  # [n_sp, s_loc, H, F]
    pos_f = jnp.transpose(pos_g, (1, 0, 2)).reshape(s_loc, -1)
    corr_f = jnp.transpose(corr_g, (1, 0, 2)).reshape(s_loc, -1)
    win_f = jnp.transpose(win_g, (1, 0, 2, 3)).reshape(
        s_loc, n_sp * max_hits, B.FEC_BITS)
    ok_f = pos_f >= 0
    sel = jax.vmap(partial(B._first_k_indices, k=max_hits))(ok_f)
    sel_ok = sel >= 0
    sel_c = jnp.clip(sel, 0, n_sp * max_hits - 1)
    windows = jnp.where(
        sel_ok[:, :, None],
        jnp.take_along_axis(win_f, sel_c[:, :, None], axis=1),
        jnp.uint8(0x40))
    hit_corr = jnp.where(
        sel_ok, jnp.take_along_axis(corr_f, sel_c, axis=1), 0)
    n_hits = jnp.minimum(jnp.sum(ok_f.astype(jnp.int32), axis=1), max_hits)

    counters = states.counters + jnp.stack(
        [jnp.full((s_loc,), t_total), jnp.full((s_loc,), t_ds_total),
         n_bits, n_hits], axis=1).astype(jnp.int32)
    out = B.BpskBlockOut(
        windows=windows, hit_corr=hit_corr, n_hits=n_hits,
        bits=bits, n_bits=n_bits,
        energies=jnp.stack(
            [timing_out.e_out,
             jnp.max(hit_corr, axis=1).astype(jnp.float32)], axis=1))
    new_state = B.BpskState(tu_phase, ds_tail, vco_out, mf_tail_out,
                            timing_out, ring_new, counters, ft_state)
    return out, new_state


def _telemetry_local(iq_re, iq_im, states: B.BpskState, tunings, dofft,
                     track_high, *, rate, n_sp, max_hits, compat_scan,
                     front_mode):
    """shard_map body: sharded front end + sharded (or, for
    compat_scan, gathered/replicated) decode tail."""
    iq_loc = CF(iq_re, iq_im)
    s_loc, t_loc = iq_loc.shape
    t_total = t_loc * n_sp
    m = rate // B.DOWN_SAMPLE_RATE

    # ---- front end: produce the mixed-domain feed locally ----------------
    if front_mode == "manual":
        feed = _front_manual_local(iq_loc, states.tu_phase, tunings,
                                   rate=rate)
        tu_phase = B._nco_advance(states.tu_phase, tunings, rate, t_total)
        ft_state = states.fft_tuner
    elif front_mode == "dofft":
        feed, ft_fin = _front_dofft_local(iq_loc, states.fft_tuner,
                                          track_high, rate=rate, n_sp=n_sp)
        tu_phase = states.tu_phase
        ft_state = jax.tree.map(lambda x: _psum_from_last(x, n_sp), ft_fin)
    else:                                   # mixed per-stream selection
        feed_m = _front_manual_local(iq_loc, states.tu_phase, tunings,
                                     rate=rate)
        tu_m = B._nco_advance(states.tu_phase, tunings, rate, t_total)
        feed_f, ft_fin = _front_dofft_local(iq_loc, states.fft_tuner,
                                            track_high, rate=rate,
                                            n_sp=n_sp)
        ft_last = jax.tree.map(lambda x: _psum_from_last(x, n_sp), ft_fin)
        sel = dofft[:, None]
        feed = CF(jnp.where(sel, feed_f.re, feed_m.re),
                  jnp.where(sel, feed_f.im, feed_m.im))
        tu_phase = jnp.where(dofft, states.tu_phase, tu_m)
        ft_state = jax.tree.map(
            lambda new, old: jnp.where(
                dofft.reshape((s_loc,) + (1,) * (new.ndim - 1)), new, old),
            ft_last, states.fft_tuner)

    ds_loc, ds_tail = _decimate_with_halo(feed, states.ds_tail, m=m,
                                          n_sp=n_sp)

    if not compat_scan:
        return _tail_sharded(ds_loc, states, tu_phase, ds_tail, ft_state,
                             rate=rate, n_sp=n_sp, max_hits=max_hits,
                             t_total=t_total)

    # compat_scan: the per-sample fp-parity scan cannot time-shard —
    # gather the decimated stream and run the identical single-device
    # tail on every rank (the round-3 replicated-tail form)
    ds = CF(lax.all_gather(ds_loc.re, "sp", axis=ds_loc.ndim - 1,
                           tiled=True),
            lax.all_gather(ds_loc.im, "sp", axis=ds_loc.ndim - 1,
                           tiled=True))
    post = partial(B._bpsk_post, t_len=t_total, max_hits=max_hits,
                   compat_scan=True)
    return jax.vmap(post)(ds, states, tu_phase, ds_tail, ft_state)


def valid_block_samples(rate: int, n_sp: int, dofft: bool = False,
                        target_seconds: float = 1.0) -> int:
    """Smallest-step valid [S, T] time length near ``target_seconds``
    for :func:`sharded_telemetry_step`: T must split into sp equal
    shards of t_loc samples with t_loc a multiple of 8*decim (one
    whole bit group per decimated 8-sample window) and at least two
    bit groups per shard; dofft streams additionally need whole 0.1 s
    FFT blocks per shard (t_loc % (rate//10) == 0,
    FUNcubeBPSKDemod.java:406-464's per-block analysis)."""
    m = rate // B.DOWN_SAMPLE_RATE
    unit = (rate // 10) if dofft else 8 * m
    t_loc_min = max(2 * 8 * m, unit)
    t_loc = max(t_loc_min,
                round(target_seconds * rate / (n_sp * unit)) * unit)
    return n_sp * t_loc


def _validate_sharded_shapes(s: int, t: int, dp: int, n_sp: int, rate: int,
                             any_dofft: bool) -> None:
    """Raise an actionable ValueError for off-contract [S, T] shapes
    instead of dying in a trace-time assert (VERDICT r4 #6)."""
    m = rate // B.DOWN_SAMPLE_RATE
    msgs = []
    if s % dp:
        msgs.append(f"S={s} streams must be a multiple of dp={dp}")
    if t % n_sp:
        msgs.append(f"T={t} samples must split over sp={n_sp} shards")
    else:
        t_loc = t // n_sp
        if t_loc % (8 * m):
            msgs.append(
                f"per-shard length T/sp={t_loc} must be a multiple of "
                f"8*decim={8 * m} (whole decimated bit groups)")
        elif t_loc < 16 * m:
            msgs.append(
                f"per-shard length T/sp={t_loc} must cover >= 2 bit "
                f"groups (>= {16 * m} samples)")
        if any_dofft and t_loc % (rate // 10):
            msgs.append(
                f"dofft streams need whole 0.1 s blocks per shard: "
                f"T/sp={t_loc} must be a multiple of {rate // 10}")
    if msgs:
        raise ValueError(
            "sharded_telemetry_step: invalid input shape — "
            + "; ".join(msgs)
            + f". Valid T are multiples of sp*8*decim={n_sp * 8 * m}"
            + (f" and of sp*rate/10={n_sp * (rate // 10)} when any "
               "stream uses dofft" if any_dofft else "")
            + f" (e.g. T={valid_block_samples(rate, n_sp, any_dofft)}; "
              "see parallel.sharded.valid_block_samples).")


def sharded_telemetry_step(mesh: Mesh, rate: int = 96000, max_hits: int = 4,
                           compat_scan: bool = False):
    """Build the jitted multi-chip telemetry step with chained state.

    Returns fn(iq, states, tunings=None, dofft=None, track_high=None) ->
    (out: demod.bpsk.BpskBlockOut, new_states: demod.bpsk.BpskState)
    where iq is [S, T] (CF or host complex) sharded (dp, sp), states is
    a batched ``bpsk_init_batch`` pytree sharded over dp, ``tunings`` is
    a host [S] array of per-stream NCO Hz (integral; defaults 12000),
    and ``dofft``/``track_high`` host [S] bools select the FFT auto-tune
    front end per stream (FUNcube<n>-bpsk-dofft / -upper,
    FUNcubeBPSKDemod.java:97-99). Consecutive calls chain bit-exactly
    like ``bpsk_block_batch`` — frames straddling two step calls are
    decoded. The decode tail is sp-sharded (see module docstring);
    ``compat_scan=True`` keeps the replicated tail.
    """
    n_sp = mesh.shape["sp"]
    dp = P("dp")
    state_specs = jax.tree.map(lambda _: dp, B.bpsk_init(B.BpskConfig()))
    out_specs = (jax.tree.map(lambda _: dp, B.BpskBlockOut(
        *([0] * len(B.BpskBlockOut._fields)))), state_specs)
    jitted = {}

    def get(front_mode):
        if front_mode not in jitted:
            local = partial(_telemetry_local, rate=rate, n_sp=n_sp,
                            max_hits=max_hits, compat_scan=compat_scan,
                            front_mode=front_mode)
            smapped = jax.shard_map(
                local, mesh=mesh,
                in_specs=(P("dp", "sp"), P("dp", "sp"), state_specs, dp,
                          dp, dp),
                out_specs=out_specs,
                check_vma=False,
            )
            jitted[front_mode] = jax.jit(smapped)
        return jitted[front_mode]

    def run(iq, states: B.BpskState, tunings=None, dofft=None,
            track_high=None):
        iq = as_cf(iq)
        s = iq.shape[0]
        if tunings is None:
            tunings = np.full(s, 12000)
        tun_arr = B.tunings_to_nu(tunings)
        assert tun_arr is not None, \
            "sharded path needs tunings in multiples of 0.1 Hz"
        dofft_np = np.broadcast_to(
            np.asarray(False if dofft is None else dofft, bool), (s,)).copy()
        th_np = np.broadcast_to(
            np.asarray(False if track_high is None else track_high, bool),
            (s,)).copy()
        _validate_sharded_shapes(s, iq.shape[-1], mesh.shape["dp"], n_sp,
                                 rate, bool(dofft_np.any()))
        if dofft_np.all():
            front_mode = "dofft"
        elif dofft_np.any():
            front_mode = "mixed"
        else:
            front_mode = "manual"
        return get(front_mode)(iq.re, iq.im, states, tun_arr, dofft_np,
                               th_np)

    return run


def sharded_spectrum(mesh: Mesh, rate: float, window: bool = True):
    """Batched FFT/PSD with blocks sharded over the whole mesh (pure DP:
    every block independent — fft.java's per-block transform at scale)."""

    def step(re, im):
        return spectrum_block(CF(re, im), rate=rate, window=window)

    sh = NamedSharding(mesh, P(("dp", "sp"), None))
    jitted = jax.jit(step, in_shardings=(sh, sh))

    def run(blocks):
        blocks = as_cf(blocks)
        return jitted(blocks.re, blocks.im)

    return run
