"""DSP ops: FIR design/application parity, decimator alignment, NCO,
spectrum formulas vs the reference's math."""

import jax.numpy as jnp
import numpy as np
import pytest

from jsdr_tpu.ops import fir, nco, spectrum, windows


def test_bandpass_weights_match_reference_formula():
    """demod.java:341-370 windowed-sinc + symmetric Hamming."""
    rate, flo, fhi, ntaps = 96000.0, 500.0, 1500.0, 21
    got = np.asarray(fir.bandpass_weights(ntaps, flo, fhi, rate))
    ordr = ntaps - 1
    want = np.zeros(ntaps)
    for n in range(ntaps):
        if n == ordr // 2:
            want[n] = 2 * (fhi - flo) / rate
        else:
            m = n - ordr // 2
            want[n] = (np.sin(2 * np.pi * fhi / rate * m) / (np.pi * m)
                       - np.sin(2 * np.pi * flo / rate * m) / (np.pi * m))
        want[n] *= 0.54 - 0.46 * np.cos(2 * np.pi * n / ordr)
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_allpass_weights():
    w = np.asarray(fir.bandpass_weights(21, None, None, 96000.0))
    assert w[10] == 1.0 and np.count_nonzero(w) == 1


def test_fir_streaming_equals_whole_block(rng):
    x = rng.normal(size=257).astype(np.float32)
    taps = fir.bandpass_weights(21, 500, 1500, 44100)
    y_all = np.asarray(fir.fir_apply(jnp.asarray(x), taps))
    y1, tail = fir.fir_apply_streaming(jnp.asarray(x[:100]), taps,
                                       jnp.zeros(20, jnp.float32))
    y2, _ = fir.fir_apply_streaming(jnp.asarray(x[100:]), taps, tail)
    np.testing.assert_allclose(
        np.concatenate([np.asarray(y1), np.asarray(y2)]), y_all, atol=1e-5)


def test_bf16x3_dot_keeps_the_lo_products(rng):
    """The three-product split is within the dropped lo*lo term (~2^-16
    of sum |a||b|) of the exact product; losing the lo products would
    leave one bf16 pass, ~2^-9."""
    a = rng.normal(size=(64, 256)).astype(np.float32)
    b = rng.normal(size=(256, 128)).astype(np.float32)
    got = np.asarray(fir._bf16x3_dot(jnp.asarray(a), jnp.asarray(b)))
    exact = a.astype(np.float64) @ b
    scale = np.abs(a).astype(np.float64) @ np.abs(b)
    assert np.max(np.abs(got - exact) / scale) < 2.0 ** -15


def test_fir_fft_matches_direct(rng):
    from jsdr_tpu.ops.cplx import to_complex
    x = (rng.normal(size=1000) + 1j * rng.normal(size=1000)).astype(np.complex64)
    taps = fir.bandpass_weights(27, 0, 4800, 96000)
    a = np.asarray(fir.fir_apply(jnp.asarray(x), taps))
    b = to_complex(fir.fir_apply_fft(x, taps))
    np.testing.assert_allclose(a, b, atol=1e-4)
    # real input stays real
    xr = rng.normal(size=512).astype(np.float32)
    ar = np.asarray(fir.fir_apply(jnp.asarray(xr), taps))
    br = np.asarray(fir.fir_apply_fft(xr, taps))
    np.testing.assert_allclose(ar, br, atol=1e-4)


def test_polyphase_decimate_matches_reference_loop(rng):
    """Reference decimator semantics (FUNcubeBPSKDemod.java:470-492):
    output k at input instant (k+1)*m-1, causal 27-tap dot."""
    m, nt = 10, 27
    x = (rng.normal(size=(2, 100)) + 1j * rng.normal(size=(2, 100))
         ).astype(np.complex64)
    taps = np.asarray(fir.bandpass_weights(nt, 0, 4800, 96000))
    got, tail = fir.polyphase_decimate(jnp.asarray(x), jnp.asarray(taps), m,
                                       gain=2.0)
    xp = np.concatenate([np.zeros((2, nt - 1), np.complex64), x], axis=1)
    want = np.zeros((2, 10), np.complex64)
    for k in range(10):
        t = (k + 1) * m - 1 + (nt - 1)
        for a in range(nt):
            want[:, k] += xp[:, t - a] * taps[a]
    np.testing.assert_allclose(np.asarray(got), 2.0 * want, atol=1e-4)
    # streaming tail continues the stream exactly
    got2, _ = fir.polyphase_decimate(jnp.asarray(x), jnp.asarray(taps), m,
                                     tail=jnp.asarray(tail), gain=2.0)
    xp2 = np.concatenate([x[:, -nt + 1:], x], axis=1)
    want2 = np.zeros((2, 10), np.complex64)
    for k in range(10):
        t = (k + 1) * m - 1 + (nt - 1)
        for a in range(nt):
            want2[:, k] += xp2[:, t - a] * taps[a]
    np.testing.assert_allclose(np.asarray(got2), 2.0 * want2, atol=1e-4)


def test_psd_formula_matches_reference():
    """fft.java:197-207: psd = 10*log10((re^2+im^2)*(2/N)^2)."""
    n = 256
    x = np.asarray(
        [np.exp(2j * np.pi * 32 * t / n) for t in range(n)], dtype=np.complex64)
    res = spectrum.spectrum_block(jnp.asarray(x)[None], rate=9600.0,
                                  window=False)
    psd = np.asarray(res.psd[0])
    # full-scale complex tone: |X[32]| = N, psd = 10*log10((N*2/N)^2) ~ 6.02
    assert abs(psd[32] - 20 * np.log10(2.0)) < 1e-3
    assert int(res.peak_freq[0]) == 32 * 9600 // 256


def test_spectrum_negative_freq_mapping():
    n = 256
    x = np.asarray(
        [np.exp(-2j * np.pi * 32 * t / n) for t in range(n)], dtype=np.complex64)
    res = spectrum.spectrum_block(jnp.asarray(x)[None], rate=9600.0,
                                  window=False)
    assert int(res.peak_freq[0]) == (224 - 256) * 9600 // 256  # negative


def test_hamming_window_convention():
    w = np.asarray(windows.hamming(256))
    assert abs(w[0] - 0.08) < 1e-6          # 0.54 - 0.46
    # reference convention: period N (not N-1), fft.java:72-73
    assert abs(w[128] - 1.0) < 1e-6


def test_quantized_nco_table():
    ph = jnp.asarray(np.linspace(0, 2 * np.pi, 100, endpoint=False))
    c, s = nco.quantized_cos_sin(ph)
    idx = (np.linspace(0, 2 * np.pi, 100, endpoint=False) * 256 / (2 * np.pi)
           ).astype(int) % 256
    np.testing.assert_allclose(np.asarray(c), np.cos(idx * 2 * np.pi / 256),
                               atol=1e-6)


def test_pallas_psd_waterfall_matches_reference(rng):
    """psd_waterfall equals its numpy formula: dBFS PSD, max-decimated
    to the display width, intensity-mapped (waterfall.java:90-107) and
    rolled to centred frequency order."""
    from jsdr_tpu.ops.spectrum import psd_waterfall
    spec = (rng.standard_normal((16, 1920)) +
            1j * rng.standard_normal((16, 1920))).astype(np.complex64) * 40
    db, line = psd_waterfall(jnp.asarray(spec), width=960)
    n = spec.shape[-1]
    db_ref = 10.0 * np.log10(np.maximum(
        np.abs(spec.astype(np.complex128)) ** 2 * (2.0 / n) ** 2, 1e-30))
    np.testing.assert_allclose(np.asarray(db), db_ref, atol=1e-4)
    dec = np.asarray(db).reshape(16, 960, 2).max(axis=-1)
    line_ref = np.roll(np.clip(255.0 - dec * -2.55, 0.0, 255.0)
                       .astype(np.uint8), 480, axis=-1)
    assert line.dtype == jnp.uint8
    assert np.array_equal(np.asarray(line), line_ref)


def test_spectrum_fused_matches_block():
    """spectrum_waterfall over contiguous [S, T] rows equals
    reshape + spectrum_block (peaks, and the PSD max-decimated), for a
    block size that is not a multiple of 128."""
    import jax
    from jsdr_tpu.ops.cplx import from_complex
    from jsdr_tpu.ops.spectrum import (spectrum_block, spectrum_waterfall,
                                       wf_group_for)

    rng = np.random.default_rng(3)
    for s, t, n in [(3, 2 * 1280, 1280), (2, 3 * 1000, 1000)]:
        sig = (rng.standard_normal((s, t))
               + 1j * rng.standard_normal((s, t))).astype(np.complex64)
        cf = from_complex(sig)
        ref = jax.jit(lambda x: spectrum_block(
            x.reshape(s, t // n, n), rate=9600.0, window=True))(cf)
        got = spectrum_waterfall(cf, n, 9600, window=True)
        q = wf_group_for(n)
        assert got.wf.shape == (s, t // n, n // q)
        want_wf = np.asarray(ref.psd).reshape(s, t // n, n // q, q).max(-1)
        np.testing.assert_allclose(np.asarray(got.wf), want_wf,
                                   rtol=0, atol=2e-3)
        np.testing.assert_array_equal(np.asarray(got.peak_freq),
                                      np.asarray(ref.peak_freq))
        np.testing.assert_allclose(np.asarray(got.peak_db),
                                   np.asarray(ref.peak_db), atol=2e-3)


def test_mix_decimate_fused_matches_reference(rng):
    """mix_decimate (tiled 128-sample NCO pattern + decimating FIR)
    equals the per-sample reference loop — mix i*cos, q*sin, then output
    k at input instant (k+1)*m-1 (FUNcubeBPSKDemod.java:382-397,
    470-492) — including the carried mixed-domain tail, across block
    lengths that are and are not multiples of 128."""
    from jsdr_tpu.ops.cplx import CF
    from jsdr_tpu.ops.fir import mix_decimate

    m, nt = 10, 27
    taps = np.random.default_rng(7).standard_normal(nt).astype(np.float32)
    ang = (np.arange(128) % 8) * (2 * np.pi / 8)
    for s, t in [(1, 1280), (3, 2560), (2, 640), (2, 4800)]:
        xr = rng.normal(size=(s, t)).astype(np.float32)
        xi = rng.normal(size=(s, t)).astype(np.float32)
        cos_pat = np.tile(np.cos(ang).astype(np.float32), (s, 1))
        sin_pat = np.tile(np.sin(ang).astype(np.float32), (s, 1))
        tr = rng.normal(size=(s, nt - 1)).astype(np.float32)
        ti = rng.normal(size=(s, nt - 1)).astype(np.float32)
        got, gt = mix_decimate(CF(jnp.asarray(xr), jnp.asarray(xi)),
                               jnp.asarray(cos_pat), jnp.asarray(sin_pat),
                               taps, m, CF(jnp.asarray(tr), jnp.asarray(ti)),
                               3.0)
        k = np.arange(t) % 128
        mixed = (xr * cos_pat[:, k]).astype(np.float64) \
            + 1j * (xi * sin_pat[:, k]).astype(np.float64)
        xp = np.concatenate([tr + 1j * ti, mixed], axis=1)
        want = np.zeros((s, t // m), np.complex128)
        for o in range(t // m):
            at = (o + 1) * m - 1 + (nt - 1)
            want[:, o] = 3.0 * (xp[:, at - nt + 1:at + 1][:, ::-1]
                                @ taps.astype(np.float64))
        np.testing.assert_allclose(np.asarray(got.re), want.real,
                                   rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(got.im), want.imag,
                                   rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(gt.re), xp[:, -(nt - 1):].real,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(gt.im), xp[:, -(nt - 1):].imag,
                                   atol=1e-6)


def test_nco_pattern_matches_full_mix(rng):
    """The 128-lane periodic NCO pattern tiles to exactly the per-sample
    quantized-table ramp (FUNcubeBPSKDemod.java:381-397), per stream."""
    from jsdr_tpu.demod.bpsk import (NU_SCALE, _nco_pattern,
                                     _tuner_full_mix, _nco_advance,
                                     pattern_mix_ok)
    from jsdr_tpu.ops.cplx import CF

    rate, t = 96000, 9600
    tunings = np.asarray([12000, 21000, 0], np.int32)
    assert pattern_mix_ok(tunings, rate)
    x = CF(jnp.asarray(rng.normal(size=(3, t)).astype(np.float32)),
           jnp.asarray(rng.normal(size=(3, t)).astype(np.float32)))
    nu0 = jnp.zeros(3, jnp.float32)
    tu = jnp.asarray(tunings * NU_SCALE)     # traced 0.1 Hz units
    want, nu_want = _tuner_full_mix(x, nu0, tu, rate)
    cos_pat, sin_pat = _nco_pattern(nu0, tu, rate)
    reps = t // 128
    got_re = (np.asarray(x.re).reshape(3, reps, 128)
              * np.asarray(cos_pat)[:, None, :])
    got_im = (np.asarray(x.im).reshape(3, reps, 128)
              * np.asarray(sin_pat)[:, None, :])
    np.testing.assert_array_equal(got_re.reshape(3, -1), np.asarray(want.re))
    np.testing.assert_array_equal(got_im.reshape(3, -1), np.asarray(want.im))
    nu_got = _nco_advance(nu0, tu, rate, t)
    np.testing.assert_array_equal(np.asarray(nu_got), np.asarray(nu_want))


def test_nco_numerators_exact():
    """Exact int32 numerator ramp == the int64 ground truth for long
    spans and awkward tunings (incl. the non-128-periodic 1200 Hz)."""
    from jsdr_tpu.demod.bpsk import nco_numerators

    rate, n = 96000, 1 << 19
    for tu, start in ((12000, 1), (1200, 1), (191999 % rate, -1945),
                      (7, 1), (95999, -345678)):
        got = np.asarray(nco_numerators(
            jnp.asarray(np.int32(12345)), jnp.asarray(np.int32(tu)),
            n, rate, start=start))
        i = np.arange(n, dtype=np.int64)
        want = (12345 + (start + i) * tu) % rate
        np.testing.assert_array_equal(got, want.astype(np.int32))


def test_static_fractional_tuner_mix(rng):
    """The legacy static-tuning path handles fractional Hz tunings."""
    from jsdr_tpu.demod.bpsk import _tuner_mix
    from jsdr_tpu.ops.cplx import CF

    rate, t = 96000, 1024
    x = CF(jnp.asarray(rng.normal(size=t).astype(np.float32)),
           jnp.asarray(rng.normal(size=t).astype(np.float32)))
    mixed, nu = _tuner_mix(x, jnp.asarray(np.float32(0.0)), 12000.5, rate)
    # phase numerator after t samples = (t * 12000.5) mod rate, stored
    # in NU_SCALE (0.1 Hz) units like every other path
    from jsdr_tpu.demod.bpsk import NU_SCALE
    np.testing.assert_allclose(float(nu), ((t * 12000.5) % rate) * NU_SCALE,
                               atol=5.0)
    assert not np.allclose(np.asarray(mixed.re), np.asarray(x.re))


def test_peak_freq_no_int32_overflow():
    """bin->Hz on a LARGE transform: the naive signed*rate//n wraps int32
    (n=192000 at 96k puts bin*rate at -2.37e9) and reported +10024 Hz for
    a -12345 Hz tone. Regression for ops.spectrum.bin_to_hz."""
    from jsdr_tpu.io.sources import synth_sine
    from jsdr_tpu.ops.spectrum import spectrum_block
    n, rate = 192000, 96000.0
    tone = synth_sine(n, -12345.0, rate, amplitude=0.5)
    res = spectrum_block(jnp.asarray(tone[None]), rate=rate, window=True)
    assert int(res.peak_freq[0]) == -12345
    # and the positive image of the truncation convention still holds
    tone = synth_sine(n, 23456.0, rate, amplitude=0.5)
    res = spectrum_block(jnp.asarray(tone[None]), rate=rate, window=True)
    assert int(res.peak_freq[0]) == 23456


def test_spectrum_waterfall_matches_decimated_psd(rng):
    """The display waterfall is bit-exactly the full PSD max-decimated
    in natural bin order (pixel p = max over bins [q*p, q*p + q)), with
    identical peaks, at the 96 kS/s and 192 kS/s display widths."""
    import jax
    from jsdr_tpu.ops.cplx import from_complex
    from jsdr_tpu.ops.spectrum import (spectrum_block, spectrum_waterfall,
                                       wf_group_for)

    assert wf_group_for(9600) == 5 and wf_group_for(19200) == 10
    n = 9600
    sig = (0.3 * (rng.standard_normal((8, n * 3))
                  + 1j * rng.standard_normal((8, n * 3)))).astype(np.complex64)
    iq = from_complex(sig)
    res = jax.jit(lambda x: spectrum_block(x.reshape(8, 3, n), rate=96000))(iq)
    got = spectrum_waterfall(iq, n, 96000)
    assert got.wf.shape == (8, 3, 1920)
    ref = np.asarray(res.psd).reshape(8, 3, n // 5, 5).max(axis=-1)
    assert np.array_equal(np.asarray(got.wf), ref)
    assert np.array_equal(np.asarray(got.peak_db), np.asarray(res.peak_db))
    assert np.array_equal(np.asarray(got.peak_freq),
                          np.asarray(res.peak_freq))
