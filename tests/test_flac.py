"""FLAC codec: encoder/decoder round-trips, native vs Python decoder
equality, and transparent FileSource ingestion — the capability the
reference gets from the jflac javax.sound SPI (Makefile:9-10)."""

import numpy as np
import pytest

from jsdr_tpu.io.flac import read_flac, write_flac, parse_streaminfo
from jsdr_tpu.io import native


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(7)
    n = 10000
    t = np.arange(n)
    sine = (np.sin(2 * np.pi * 441 * t / 44100) * 12000).astype(np.int64)
    noisy = sine + rng.integers(-400, 400, n)          # fixed-pred friendly
    loud = rng.integers(-32768, 32767, n)              # verbatim territory
    return np.stack([noisy, loud], axis=-1)


@pytest.mark.parametrize("stereo", ["independent", "left_side",
                                    "side_right", "mid_side"])
def test_roundtrip_python(signal, tmp_path, stereo):
    p = tmp_path / f"{stereo}.flac"
    write_flac(p, signal, 44100, stereo=stereo)
    dec, rate, bps = read_flac(p, prefer_native=False)
    assert (rate, bps) == (44100, 16)
    np.testing.assert_array_equal(dec, signal)


@pytest.mark.parametrize("stereo", ["independent", "left_side",
                                    "side_right", "mid_side"])
def test_native_matches_python(signal, tmp_path, stereo):
    if not native.available():
        pytest.skip("native IO library not built")
    p = tmp_path / f"{stereo}.flac"
    write_flac(p, signal, 44100, stereo=stereo)
    data = p.read_bytes()
    got = native.flac_decode_native(data, 2, len(signal))
    assert got is not None, "native decoder rejected a valid stream"
    np.testing.assert_array_equal(got.reshape(-1, 2), signal)


def test_roundtrip_mono_and_constant(tmp_path):
    x = np.full(5000, -321, np.int64)
    p = tmp_path / "c.flac"
    write_flac(p, x, 8000)
    dec, rate, _ = read_flac(p, prefer_native=False)
    assert rate == 8000
    np.testing.assert_array_equal(dec[:, 0], x)
    # constant subframes compress massively
    assert p.stat().st_size < 300


def test_streaminfo_fields(signal, tmp_path):
    p = tmp_path / "s.flac"
    write_flac(p, signal, 96000)
    rate, ch, bps, total, md5, _ = parse_streaminfo(p.read_bytes())
    assert (rate, ch, bps, total) == (96000, 2, 16, len(signal))
    import hashlib
    ref = hashlib.md5(signal.astype("<i2").tobytes()).digest()
    assert md5 == ref


def test_filesource_reads_flac(tmp_path, sine4410):
    """End-to-end: FLAC-encoded sine4410 shows the +-4410 Hz pair."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jsdr_tpu.io.sources import FileSource
    from jsdr_tpu.ops.cplx import from_complex
    from jsdr_tpu.ops.spectrum import spectrum_block

    raw = sine4410["s16"]
    p = tmp_path / "sine4410.flac"
    write_flac(p, raw.astype(np.int64), 44100, stereo="left_side")
    src = FileSource(p)
    assert src.rate == 44100 and src.channels == 2
    iq = src.all()
    ref = raw.reshape(-1).astype(np.float32) / 32767.0
    np.testing.assert_allclose(iq.view(np.float32), ref, atol=1e-6)
    res = spectrum_block(from_complex(jnp.asarray(iq[None, :4096])),
                         rate=44100.0, window=True)
    assert abs(abs(int(np.asarray(res.peak_freq).ravel()[0])) - 4410) < 30


def test_corrupt_stream_rejected(signal, tmp_path):
    p = tmp_path / "x.flac"
    write_flac(p, signal, 44100)
    data = bytearray(p.read_bytes())
    data[len(data) // 2] ^= 0xFF                     # flip a frame byte
    if native.available():
        assert native.flac_decode_native(bytes(data), 2, len(signal)) is None
    with pytest.raises(ValueError):
        from jsdr_tpu.io.flac import _decode_frames_py
        rate, ch, bps, total, _md5, pos = parse_streaminfo(bytes(data))
        _decode_frames_py(bytes(data), pos, rate, ch, bps, total)


def test_lpc_rice2_escape_wasted_bits(tmp_path):
    """Hand-crafted stream covering decoder paths the in-tree encoder
    never emits: LPC prediction, Rice2 (5-bit) params, an escape (raw)
    partition, and wasted bits."""
    import struct
    from jsdr_tpu.io.flac import (_BitWriter, _utf8_coded_number, crc8,
                                  crc16)

    rng = np.random.default_rng(11)
    bs, bps, order, shift = 64, 16, 2, 5
    coefs = [55, -23]
    # samples: even (1 wasted bit), generated from the LPC recurrence
    half = np.zeros(bs, np.int64)
    half[:order] = [100, -200]
    res = rng.integers(-120, 120, bs - order)
    for i in range(order, bs):
        pred = (coefs[0] * half[i - 1] + coefs[1] * half[i - 2]) >> shift
        half[i] = pred + res[i - order]
    assert np.abs(half).max() < 1 << 14
    x = half << 1                                  # 1 wasted bit

    bw = _BitWriter()
    bw.write(0x3FFE, 14); bw.write(0, 2)
    bw.write(7, 4)                                 # explicit 16-bit blocksize
    bw.write(0, 4)                                 # rate from STREAMINFO
    bw.write(0, 4)                                 # 1 channel
    bw.write(4, 3); bw.write(0, 1)                 # 16-bit
    for b in _utf8_coded_number(0):
        bw.write(b, 8)
    bw.write(bs - 1, 16)
    bw.write(crc8(bytes(bw.buf)), 8)
    # subframe: LPC order 2, wasted=1
    bw.write(0, 1); bw.write(32 + order - 1, 6)
    bw.write(1, 1)                                 # wasted-bits flag
    bw.write(1, 1)                                 # unary 0 -> wasted = 1
    eb = bps - 1
    for v in half[:order]:
        bw.write(int(v), eb)
    bw.write(12 - 1, 4)                            # precision 12
    bw.write(shift, 5)
    for c in coefs:
        bw.write(c, 12)
    # residual: Rice2, partition order 1; part 0 escape raw 9 bits, part 1 rice
    bw.write(1, 2); bw.write(1, 4)
    bw.write(31, 5); bw.write(9, 5)                # escape, 9 raw bits
    n0 = bs // 2 - order
    for v in res[:n0]:
        bw.write(int(v), 9)
    k = 6
    bw.write(k, 5)
    for v in res[n0:]:
        u = (int(v) << 1) ^ (int(v) >> 63)
        bw.write_unary(u >> k)
        bw.write(u & ((1 << k) - 1), k)
    bw.align_byte()
    frame = bw.getvalue() + struct.pack(">H", crc16(bw.getvalue()))

    si = _BitWriter()
    si.write(bs, 16); si.write(bs, 16); si.write(0, 24); si.write(0, 24)
    si.write(48000, 20); si.write(0, 3); si.write(bps - 1, 5); si.write(bs, 36)
    si.align_byte()
    body = si.getvalue() + b"\x00" * 16            # md5 unset
    data = (b"fLaC" + bytes([0x80]) + len(body).to_bytes(3, "big")
            + body + frame)

    p = tmp_path / "lpc.flac"
    p.write_bytes(data)
    dec, rate, _ = read_flac(p, prefer_native=False)
    assert rate == 48000
    np.testing.assert_array_equal(dec[:, 0], x)
    if native.available():
        got = native.flac_decode_native(data, 1, bs)
        assert got is not None
        np.testing.assert_array_equal(got, x)
