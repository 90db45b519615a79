"""End-to-end telemetry: synthetic FUNcube downlink -> tuner -> decimate ->
VCO/matched filter -> timing scan -> sync search -> AO-40 FEC decode."""

import jax.numpy as jnp
import numpy as np
import pytest

from jsdr_tpu.demod.bpsk import BpskConfig, bpsk_init, bpsk_block
from jsdr_tpu.fec.decoder import fec_decode
from jsdr_tpu.io.sources import synth_bpsk_stream
from jsdr_tpu.ops.cplx import CF


def _run_stream(sig, payloads, cfg, block):
    sig = np.concatenate([sig, np.zeros((-len(sig)) % block, np.complex64)])
    st = bpsk_init(cfg)
    good = 0
    total_hits = 0
    for b in range(len(sig) // block):
        out, st = bpsk_block(jnp.asarray(sig[b * block:(b + 1) * block]), cfg, st)
        nh = int(out.n_hits)
        total_hits += nh
        if nh:
            res = fec_decode(out.windows[:nh])
            for i in range(nh):
                if bool(res.ok[i]) and any(
                        np.array_equal(np.asarray(res.payload[i]), p)
                        for p in payloads):
                    good += 1
    return good, total_hits, st


def test_clean_stream_decodes_all_frames(rng):
    payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=96000, carrier_offset=12000.0)
    cfg = BpskConfig(rate=96000, tuning=12000.0)
    good, hits, st = _run_stream(sig, payloads, cfg, 96000)
    assert good == 2
    counters = np.asarray(st.counters)
    assert counters[1] == counters[0] // 10          # decimation ratio
    # one bit per 80 input samples while signal is present (energy-gated,
    # so the zero-pad tail emits nothing)
    assert counters[2] == pytest.approx(len(sig) // 80, abs=30)


def test_noisy_stream_decodes(rng):
    payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=96000, noise_rms=0.5, seed=3)
    cfg = BpskConfig(rate=96000, tuning=12000.0)
    good, _, _ = _run_stream(sig, payloads, cfg, 96000)
    assert good == 2


def test_block_size_invariance(rng):
    """Chained state must make block size irrelevant to the decode result."""
    payloads = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=96000, preamble_bits=200)
    cfg = BpskConfig(rate=96000, tuning=12000.0)
    g1, _, _ = _run_stream(sig, payloads, cfg, 96000)
    g2, _, _ = _run_stream(sig, payloads, cfg, 48000)
    g3, _, _ = _run_stream(sig, payloads, cfg, 240000)
    assert g1 == g2 == g3 == 1


def test_tenth_hz_tuning_traced_no_recompile(rng):
    """Round-4: tunings that are multiples of 0.1 Hz ride the exact
    0.1 Hz-unit integer-numerator path — traced data, decode works, and
    retuning to another 0.1 Hz multiple does NOT recompile (round 3
    pushed any fractional tuning onto a per-tuning-set recompiling
    static path). Sub-0.1 Hz values still warn and recompile."""
    import warnings
    from jsdr_tpu.demod.bpsk import (_bpsk_block_batched, bpsk_block_batch,
                                     bpsk_init_batch, pattern_mix_ok,
                                     tunings_to_nu)

    assert tunings_to_nu([12000.5]) is not None
    assert tunings_to_nu([12000.05]) is None
    assert not pattern_mix_ok([12000.5], 96000)   # general path

    payloads = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=96000, carrier_offset=12000.5,
                            preamble_bits=200)
    n = len(sig) + (-len(sig)) % 96000
    iq = np.zeros((1, n), np.complex64)
    iq[0, :len(sig)] = sig
    cfg = BpskConfig(rate=96000)
    states = bpsk_init_batch(cfg, 1)
    good = 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # traced path must NOT warn
        for b in range(n // 96000):
            out, states = bpsk_block_batch(
                iq[:, b * 96000:(b + 1) * 96000], cfg, states,
                np.asarray([12000.5]))
            nh = int(out.n_hits[0])
            if nh:
                res = fec_decode(out.windows[0, :nh])
                good += sum(bool(res.ok[i]) and np.array_equal(
                    np.asarray(res.payload[i]), payloads[0])
                    for i in range(nh))
    assert good == 1
    n_compiles = _bpsk_block_batched._cache_size()
    bpsk_block_batch(iq[:, :96000], cfg, bpsk_init_batch(cfg, 1),
                     np.asarray([11999.9]))
    assert _bpsk_block_batched._cache_size() == n_compiles
    # sub-0.1 Hz: the legacy static path, with its recompile warning
    with pytest.warns(RuntimeWarning, match="0.1 Hz"):
        bpsk_block_batch(iq[:, :96000], cfg, bpsk_init_batch(cfg, 1),
                         np.asarray([12000.05]))


def test_wrong_tuning_no_decode(rng):
    """Tuned 3 kHz off, the decimation filter rejects the signal."""
    payloads = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=96000, preamble_bits=200)
    cfg = BpskConfig(rate=96000, tuning=21000.0)
    good, _, _ = _run_stream(sig, payloads, cfg, 96000)
    assert good == 0


def test_per_stream_tunings_one_call(rng):
    """Two streams with INDEPENDENT tunings (12 kHz and 9 kHz) decode in
    ONE bpsk_block_batch call — the analog of N FUNcubeBPSKDemod tabs
    each with its own FUNcube<n>-bpsk-tuning (jsdr.java:479-484,
    FUNcubeBPSKDemod.java:195-196) — and retuning does NOT recompile."""
    from jsdr_tpu.demod.bpsk import (_bpsk_block_batched, bpsk_block_batch,
                                     bpsk_init_batch)

    payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    sig_a = synth_bpsk_stream(payloads[:1], rate=96000,
                              carrier_offset=12000.0, preamble_bits=200)
    sig_b = synth_bpsk_stream(payloads[1:], rate=96000,
                              carrier_offset=9000.0, preamble_bits=200)
    n = max(len(sig_a), len(sig_b))
    n += (-n) % 96000
    iq = np.zeros((2, n), np.complex64)
    iq[0, :len(sig_a)] = sig_a
    iq[1, :len(sig_b)] = sig_b

    cfg = BpskConfig(rate=96000)
    states = bpsk_init_batch(cfg, 2)
    tunings = np.asarray([12000, 9000])
    good = [0, 0]
    block = 96000
    for b in range(n // block):
        out, states = bpsk_block_batch(iq[:, b * block:(b + 1) * block],
                                       cfg, states, tunings)
        for s in range(2):
            nh = int(out.n_hits[s])
            if not nh:
                continue
            res = fec_decode(out.windows[s, :nh])
            for i in range(nh):
                if bool(res.ok[i]) and np.array_equal(
                        np.asarray(res.payload[i]), payloads[s]):
                    good[s] += 1
    assert good == [1, 1]
    n_compiles = _bpsk_block_batched._cache_size()
    # retune both streams: same compilation must be reused (traced data)
    bpsk_block_batch(iq[:, :block], cfg, bpsk_init_batch(cfg, 2),
                     np.asarray([9000, 12000]))
    assert _bpsk_block_batched._cache_size() == n_compiles


def test_general_mix_path_decodes(rng):
    """A tuning whose NCO ramp is NOT 128-lane periodic (1200 Hz at
    96 kS/s) takes the exact-numerator general path and still decodes."""
    from jsdr_tpu.demod.bpsk import pattern_mix_ok

    assert not pattern_mix_ok([1200], 96000)
    payloads = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=96000, carrier_offset=1200.0,
                            preamble_bits=200)
    cfg = BpskConfig(rate=96000, tuning=1200.0)
    good, _, _ = _run_stream(sig, payloads, cfg, 96000)
    assert good == 1


def test_compat_scan_warns_on_accelerator(rng, monkeypatch):
    """compat_scan=True on a non-CPU backend runs one sequential scan
    step per decimated sample: the dispatcher must warn so the parity
    knob is never flipped on the GPU by accident."""
    import warnings
    import jax
    from jsdr_tpu.demod.bpsk import bpsk_block_batch, bpsk_init_batch

    class _FakeDev:
        platform = "gpu"

    real_devices = jax.devices

    def fake_devices(*a, **kw):
        return [_FakeDev()] if not a and not kw else real_devices(*a, **kw)

    monkeypatch.setattr(jax, "devices", fake_devices)
    cfg = BpskConfig(rate=96000, tuning=12000.0, compat_scan=True)
    iq = np.zeros((1, 9600), np.complex64)
    with pytest.warns(RuntimeWarning, match="compat_scan"):
        bpsk_block_batch(iq, cfg, bpsk_init_batch(cfg, 1))
    monkeypatch.undo()
    # no warning without compat_scan
    cfg2 = BpskConfig(rate=96000, tuning=12000.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bpsk_block_batch(iq, cfg2, bpsk_init_batch(cfg2, 1))


def test_parallel_timing_equals_scan(rng):
    """The associative-scan timing recovery must produce bit-for-bit the
    same stream as the per-sample scan (compat mode)."""
    payloads = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=96000, noise_rms=0.4, seed=8)
    block = 96000
    sig = np.concatenate([sig, np.zeros((-len(sig)) % block, np.complex64)])
    cfg_a = BpskConfig(rate=96000, tuning=12000.0, compat_scan=True)
    cfg_b = BpskConfig(rate=96000, tuning=12000.0, compat_scan=False)
    st_a, st_b = bpsk_init(cfg_a), bpsk_init(cfg_b)
    for b in range(len(sig) // block):
        blk = jnp.asarray(sig[b * block:(b + 1) * block])
        oa, st_a = bpsk_block(blk, cfg_a, st_a)
        ob, st_b = bpsk_block(blk, cfg_b, st_b)
        na, nb = int(oa.n_bits), int(ob.n_bits)
        assert na == nb
        assert np.array_equal(np.asarray(oa.bits)[:na], np.asarray(ob.bits)[:nb])
        assert int(oa.n_hits) == int(ob.n_hits)
    assert int(st_a.timing.peak) == int(st_b.timing.peak)
    assert int(st_a.timing.new_peak) == int(st_b.timing.new_peak)


def _rand_timing_states(rng, s):
    from jsdr_tpu.demod.bpsk import TimingState, bpsk_init_batch
    tm = bpsk_init_batch(BpskConfig(rate=96000), s).timing
    # non-trivial carried state: mid-decay EMAs, scheduled peaks,
    # a previous symbol
    return TimingState(
        e_ema=(rng.random((s, 8)).astype(np.float32) * 2e4),
        pos=tm.pos,
        peak=rng.integers(0, 8, s).astype(np.int32),
        new_peak=rng.integers(0, 8, s).astype(np.int32),
        e_out=(rng.random(s).astype(np.float32) * 100),
        last_iq=rng.standard_normal((s, 2)).astype(np.float32) * 50,
    )


def _bpsk_like_mf(rng, s, t_ds, amp):
    # strong alternating symbols + noise, so the energy gate and the
    # peak schedule both flip realistically
    mfr = (rng.standard_normal((s, t_ds)) * 30
           + amp * np.sign(rng.standard_normal((s, t_ds // 8)))
           .repeat(8, axis=1)).astype(np.float32)
    mfi = (rng.standard_normal((s, t_ds)) * 30).astype(np.float32)
    return CF(jnp.asarray(mfr), jnp.asarray(mfi))


def _timing_parallel_chained(mf, tm, n_blocks):
    import jax
    from jsdr_tpu.demod.bpsk import _timing_parallel
    t = mf.shape[-1] // n_blocks
    valid, bit = [], []
    for b in range(n_blocks):
        v, bt, _di, _e2, tm = jax.vmap(_timing_parallel)(
            mf[:, b * t:(b + 1) * t], tm)
        valid.append(np.asarray(v))
        bit.append(np.asarray(bt))
    return np.concatenate(valid, 1), np.concatenate(bit, 1), tm


@pytest.mark.parametrize("case", ["s3_t4800", "s8_t9600", "s5_t16384",
                                  "chained", "batched_decode"])
def test_timing_parallel_matches_scan(rng, case):
    """The parallel timing recovery (_timing_parallel) against the
    per-sample scan (_timing_scan, compat mode): identical bit decisions
    and peak schedule, carried energies to fp-reassociation tolerance,
    from random carried states at several (streams, samples) shapes;
    two chained parallel blocks against one scan over both; and the
    batched chain's decoded frames and counters in both modes."""
    import jax
    from jsdr_tpu.demod.bpsk import _timing_scan, bpsk_block_batch, \
        bpsk_init_batch

    if case == "batched_decode":
        payloads = rng.integers(0, 256, (1, 256), dtype=np.uint8)
        sig = synth_bpsk_stream(payloads, rate=96000, preamble_bits=200,
                                noise_rms=0.25)
        n = len(sig) + (-len(sig)) % 96000
        iq = np.zeros((2, n), np.complex64)
        iq[0, :len(sig)] = sig
        iq[1, :len(sig)] = sig[::-1]
        outs = {}
        for compat in (False, True):
            cfg = BpskConfig(rate=96000, tuning=12000.0, compat_scan=compat)
            st = bpsk_init_batch(cfg, 2)
            decoded = 0
            for b in range(n // 96000):
                out, st = bpsk_block_batch(
                    iq[:, b * 96000:(b + 1) * 96000], cfg, st)
                nh = int(out.n_hits[0])
                if nh:
                    res = fec_decode(out.windows[0, :nh])
                    decoded += sum(bool(res.ok[i]) and np.array_equal(
                        np.asarray(res.payload[i]), payloads[0])
                        for i in range(nh))
            outs[compat] = (decoded, np.asarray(st.counters))
        assert outs[True][0] == outs[False][0] == 1
        assert np.array_equal(outs[True][1], outs[False][1])
        return

    if case == "chained":
        s, t_ds, n_blocks, amp = 4, 2 * 4800, 2, 140
    else:
        s, t_ds = (int(v[1:]) for v in case.split("_"))
        n_blocks, amp = 1, 150
    tm = _rand_timing_states(rng, s)
    mf = _bpsk_like_mf(rng, s, t_ds, amp)
    v_p, b_p, ts_p = _timing_parallel_chained(mf, tm, n_blocks)
    v_s, b_s, _di, _e2, ts_s = jax.vmap(_timing_scan)(mf, tm)
    v_s, b_s = np.asarray(v_s), np.asarray(b_s)
    for k in range(s):
        # the scan emits per sample, the parallel form per bit slot;
        # both in time order, so the valid decisions must line up
        assert np.array_equal(b_p[k][v_p[k]], b_s[k][v_s[k]]), k
    assert np.array_equal(np.asarray(ts_p.peak), np.asarray(ts_s.peak))
    assert np.array_equal(np.asarray(ts_p.new_peak),
                          np.asarray(ts_s.new_peak))
    np.testing.assert_allclose(np.asarray(ts_p.e_ema),
                               np.asarray(ts_s.e_ema), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(np.asarray(ts_p.e_out),
                               np.asarray(ts_s.e_out), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(ts_p.last_iq),
                               np.asarray(ts_s.last_iq), rtol=1e-6,
                               atol=1e-4)


def test_mixed_dofft_batch_one_call(rng):
    """Stream 0 manually tuned at 12 kHz and stream 1 FFT-auto-tuned (to
    an 11.9 kHz carrier it was never told about) decode in ONE batched
    call — per-instance FUNcube<n>-bpsk-dofft (FUNcubeBPSKDemod.java:
    97-99, jsdr.java:479-484). Toggling flag VALUES must not recompile
    within the mixed class."""
    from jsdr_tpu.demod.bpsk import (_bpsk_block_batched, bpsk_block_batch,
                                     bpsk_init_batch)

    # the dofft stream reuses test_fft_tune_full_chain_decodes' known-
    # good signal (the reference's box-average auto-tuner is sloppy by
    # design — FUNcubeBPSKDemod.java:433-451 — and some payload draws
    # land it ~300 Hz off, past the differential demod's tolerance; that
    # marginality is the tuner's, not the batching's)
    pay_b = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    pay_a = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    payloads = np.concatenate([pay_a, pay_b])
    sig_a = synth_bpsk_stream(payloads[:1], rate=96000,
                              carrier_offset=12000.0, preamble_bits=400)
    sig_b = synth_bpsk_stream(payloads[1:], rate=96000,
                              carrier_offset=11900.0, preamble_bits=400,
                              seed=2)
    n = max(len(sig_a), len(sig_b))
    n += (-n) % 96000
    iq = np.zeros((2, n), np.complex64)
    iq[0, :len(sig_a)] = sig_a
    iq[1, :len(sig_b)] = sig_b

    cfg = BpskConfig(rate=96000)
    states = bpsk_init_batch(cfg, 2)
    dofft = [False, True]
    good = [0, 0]
    block = 96000
    for b in range(n // block):
        out, states = bpsk_block_batch(iq[:, b * block:(b + 1) * block],
                                       cfg, states, np.asarray([12000, 0]),
                                       dofft=dofft)
        for s in range(2):
            nh = int(out.n_hits[s])
            if not nh:
                continue
            res = fec_decode(out.windows[s, :nh])
            for i in range(nh):
                if bool(res.ok[i]) and np.array_equal(
                        np.asarray(res.payload[i]), payloads[s]):
                    good[s] += 1
    assert good == [1, 1]
    # the auto stream locked near the carrier; the manual stream's
    # fft-tuner state never advanced
    assert int(states.fft_tuner.centre_bin[1]) == pytest.approx(1310, abs=15)
    assert int(states.fft_tuner.centre_bin[0]) == 0
    n_compiles = _bpsk_block_batched._cache_size()
    bpsk_block_batch(iq[:, :block], cfg, bpsk_init_batch(cfg, 2),
                     np.asarray([9000, 0]), dofft=[True, False],
                     track_high=[False, True])
    assert _bpsk_block_batched._cache_size() == n_compiles


def test_merged_spectrum_step_matches_staged(rng):
    """bpsk_block_batch_spectrum must reproduce spectrum_waterfall +
    bpsk_block_batch run separately: identical waterfall lines, peaks,
    decode outputs, and carried state."""
    from jsdr_tpu.demod.bpsk import (bpsk_block_batch,
                                     bpsk_block_batch_spectrum,
                                     bpsk_init_batch)
    from jsdr_tpu.ops.cplx import from_complex
    from jsdr_tpu.ops.spectrum import spectrum_waterfall

    payloads = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=96000, preamble_bits=200,
                            noise_rms=0.2)
    block = 96000 * 2
    n = len(sig) + (-len(sig)) % block
    iq = np.zeros((2, n), np.complex64)
    iq[0, :len(sig)] = sig
    iq[1, :len(sig)] = sig[::-1]
    cfg = BpskConfig(rate=96000, tuning=12000.0)

    st_m = bpsk_init_batch(cfg, 2)
    st_s = bpsk_init_batch(cfg, 2)
    decoded = 0
    for b in range(n // block):
        blk = iq[:, b * block:(b + 1) * block]
        spec, out_m, st_m = bpsk_block_batch_spectrum(blk, cfg, st_m)
        ref = spectrum_waterfall(from_complex(blk), 9600, 96000)
        out_s, st_s = bpsk_block_batch(blk, cfg, st_s)
        assert spec.wf.shape == (2, block // 9600, 1920)
        assert np.array_equal(np.asarray(spec.wf), np.asarray(ref.wf))
        assert np.array_equal(np.asarray(spec.peak_db),
                              np.asarray(ref.peak_db))
        assert np.array_equal(np.asarray(spec.peak_freq),
                              np.asarray(ref.peak_freq))
        assert np.array_equal(np.asarray(out_m.n_bits),
                              np.asarray(out_s.n_bits))
        assert np.array_equal(np.asarray(out_m.windows),
                              np.asarray(out_s.windows))
        nh = int(out_m.n_hits[0])
        if nh:
            res = fec_decode(out_m.windows[0, :nh])
            decoded += int(res.ok.sum())
    assert decoded == 1
    assert np.array_equal(np.asarray(st_m.counters),
                          np.asarray(st_s.counters))
    assert np.array_equal(np.asarray(st_m.ring), np.asarray(st_s.ring))


def test_merged_spectrum_step_192k(rng):
    """The 192 kS/s geometry (m=20, n=19200, 1920-pixel lines at q=10):
    bpsk_block_batch_spectrum must match the separate pair — one 1 s
    block, decode-path counters and waterfall lines compared."""
    from jsdr_tpu.demod.bpsk import (bpsk_block_batch,
                                     bpsk_block_batch_spectrum,
                                     bpsk_init_batch)
    from jsdr_tpu.ops.cplx import from_complex
    from jsdr_tpu.ops.spectrum import spectrum_waterfall, wf_group_for

    assert wf_group_for(19200) == 10
    rate = 192000
    payloads = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=rate, preamble_bits=200,
                            noise_rms=0.2)[:rate]
    iq = np.zeros((1, rate), np.complex64)
    iq[0, :len(sig)] = sig
    cfg = BpskConfig(rate=rate, tuning=12000.0)
    st_m = bpsk_init_batch(cfg, 1)
    st_s = bpsk_init_batch(cfg, 1)
    spec, out_m, st_m = bpsk_block_batch_spectrum(iq, cfg, st_m)
    ref = spectrum_waterfall(from_complex(iq), rate // 10, rate)
    out_s, st_s = bpsk_block_batch(iq, cfg, st_s)
    assert spec.wf.shape == (1, 10, 1920)
    assert np.array_equal(np.asarray(spec.wf), np.asarray(ref.wf))
    assert np.array_equal(np.asarray(spec.peak_db), np.asarray(ref.peak_db))
    assert np.array_equal(np.asarray(out_m.n_bits), np.asarray(out_s.n_bits))
    assert np.array_equal(np.asarray(out_m.windows),
                          np.asarray(out_s.windows))
    assert np.array_equal(np.asarray(st_m.counters), np.asarray(st_s.counters))


def test_chained_fori_loop_steps_equal_iterated(rng):
    """bench.py's steady-state measurement runs k dependent steps inside
    ONE jit via lax.fori_loop in the HOIST-PROOF form: the input's real
    plane rides the loop carry and one sample is overwritten with a
    state-derived value each iteration, so even state-free ops (the
    display spectrum) cannot be moved out of the loop by XLA's
    while-loop invariant code motion. (The loop-carried demod state
    alone is NOT enough: LICM hoisted the whole spectrum of an earlier
    constant-input form — values were identical, timing was not.) Guard
    the value contract:
    the chained form must produce bit-identical final state and forced
    sums vs k python-iterated steps applying the same perturbation."""
    import jax
    from jsdr_tpu.demod.bpsk import (bpsk_block_batch_spectrum,
                                     bpsk_init_batch)

    payloads = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads[:1], rate=96000, preamble_bits=200,
                            noise_rms=0.2)
    block = 96000 * 2
    n = block
    iq = np.zeros((2, n), np.complex64)
    iq[0] = sig[:n]
    iq[1] = sig[len(sig) - n:]
    cfg = BpskConfig(rate=96000, tuning=12000.0)

    def forced_of(spec, out):
        return (spec.wf.sum() + spec.peak_db.sum() + spec.peak_freq.sum()
                + out.windows.astype(jnp.int32).sum() + out.hit_corr.sum()
                + out.n_hits.sum() + out.n_bits.sum()).astype(jnp.float32)

    k = 3

    @jax.jit
    def chained(iq_re, iq_im, states):
        def body(_, carry):
            acc, re_buf, st = carry
            spec, out, st = bpsk_block_batch_spectrum(
                CF(re_buf, iq_im), cfg, st)
            f = forced_of(spec, out)
            re_buf = jax.lax.dynamic_update_slice(
                re_buf, (f * 1e-12)[None, None], (0, 0))
            return acc + f, re_buf, st
        return jax.lax.fori_loop(0, k, body,
                                 (jnp.float32(0.0), iq_re, states))

    @jax.jit
    def one(iq_re, iq_im, states):
        spec, out, st = bpsk_block_batch_spectrum(CF(iq_re, iq_im), cfg,
                                                  states)
        f = forced_of(spec, out)
        re2 = jax.lax.dynamic_update_slice(
            iq_re, (f * 1e-12)[None, None], (0, 0))
        return f, re2, st

    from jsdr_tpu.ops.cplx import from_complex
    iq_cf = from_complex(iq)
    acc_c, re_c, st_c = chained(iq_cf.re, iq_cf.im, bpsk_init_batch(cfg, 2))
    acc_i, st_i = jnp.float32(0.0), bpsk_init_batch(cfg, 2)
    re_i = iq_cf.re
    for _ in range(k):
        f, re_i, st_i = one(re_i, iq_cf.im, st_i)
        acc_i = acc_i + f
    for a, b in zip(jax.tree.leaves(st_c), jax.tree.leaves(st_i)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(re_c), np.asarray(re_i))
    assert np.asarray(acc_c) == pytest.approx(np.asarray(acc_i), rel=1e-6)
    # the state must actually advance across iterations
    assert int(np.asarray(st_c.counters)[:, 0].sum()) == 2 * k * n
