"""IO (conversion, sources, framing, native lib), runtime services, and
display reductions."""

import numpy as np
import pytest

from jsdr_tpu.io import convert, framer, native, sources
from jsdr_tpu.io.fcd import FCD
from jsdr_tpu.runtime import Config, PubSub, StageTimers, save_state, load_state


def test_s16_conversion_wrapping_dc(rng):
    """Java `s += (short)corr` wraps at 16 bits (JavaAudio.java:281-289)."""
    s = np.array([32767, -32768, -32768, 32767], dtype=np.int16)
    out = convert.s16le_to_complex(s, channels=2, i_corr=1, q_corr=-1)
    assert out[0].real == np.float32(-32768 / 32767)   # 32767+1 wraps
    assert out[0].imag == np.float32(32767 / 32767)    # -32768-1 wraps
    assert out[1].real == np.float32(-32767 / 32767)   # -32768+1, no wrap
    assert out[1].imag == np.float32(32766 / 32767)    # 32767-1, no wrap


def test_native_matches_numpy(rng):
    if not native.available():
        pytest.skip("native lib not built")
    s = rng.integers(-32768, 32768, 4096, dtype=np.int16)
    a = native.s16le_to_complex_native(s, 2, 7, -9)
    native._lib, saved = None, native._lib
    try:
        b = convert.s16le_to_complex(s, 2, 7, -9)
    finally:
        native._lib = saved
    assert np.array_equal(a, b)


def test_mono_maps_q_zero():
    s = np.array([100, -100], dtype=np.int16)
    out = convert.s16le_to_complex(s, channels=1)
    assert np.all(out.imag == 0) and out[0].real > 0


def test_roundtrip_s16(rng):
    iq = (rng.uniform(-1, 1, 64) + 1j * rng.uniform(-1, 1, 64)).astype(np.complex64)
    back = convert.s16le_to_complex(np.frombuffer(
        convert.complex_to_s16le(iq), dtype="<i2"))
    assert np.max(np.abs(back - iq)) < 1e-4


def test_file_source_raw_and_wav(tmp_path, rng):
    iq = sources.synth_sine(4410, 441.0, 44100.0, analytic=False)
    raw = tmp_path / "t.raw"
    raw.write_bytes(convert.complex_to_s16le(iq))
    src = sources.FileSource(raw, rate=44100)
    got = src.all()
    assert got.shape == iq.shape
    # loop semantics: blocks() wraps at EOF
    blocks = src.blocks(4000)
    b0 = next(blocks)
    assert len(b0) == 4000


def _write_wav(path, body: bytes, tag: int, channels: int, rate: int,
               bits: int, extensible: bool = False):
    """Hand-rolled WAV writer (the stdlib can't write float/extensible)."""
    import struct
    balign = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else tag, channels,
                      rate, rate * balign, balign, bits)
    if extensible:
        guid_tail = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt += struct.pack("<HHI", 22, bits, 0x3)
        fmt += struct.pack("<H", tag) + guid_tail
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
              + b"data" + struct.pack("<I", len(body)) + body)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE"
                     + chunks)


def test_wav_width_fallback(tmp_path):
    """JavaAudio.java:369-395 parity: any common WAV width converts to
    the 16-bit full-scale convention (8/24/32-bit PCM, float 32/64,
    extensible wrappers)."""
    import struct
    s16 = np.array([0, 1000, -1000, 32767, -32768, 12345], dtype=np.int16)

    q8 = np.clip(np.round(s16 / 256.0), -128, 127).astype(np.int16)
    cases = {
        "w8.wav": (bytes((q8 + 128).astype(np.uint8)), 1, 8, False),
        "w16.wav": (s16.tobytes(), 1, 16, False),
        "w24.wav": (b"".join(struct.pack("<i", int(v) << 8)[:3] for v in s16),
                    1, 24, False),
        "w32.wav": ((s16.astype(np.int32) << 16).tobytes(), 1, 32, False),
        "f32.wav": ((s16.astype(np.float32) / 32767.0).tobytes(), 3, 32,
                    False),
        "f64.wav": ((s16.astype(np.float64) / 32767.0).tobytes(), 3, 64,
                    False),
        "f32x.wav": ((s16.astype(np.float32) / 32767.0).tobytes(), 3, 32,
                     True),
    }
    for name, (body, tag, bits, ext) in cases.items():
        p = tmp_path / name
        _write_wav(p, body, tag, 2, 48000, bits, extensible=ext)
        got, channels, rate = sources.read_wav(p)
        assert (channels, rate) == (2, 48000), name
        if bits == 8:
            # 8-bit keeps only the top byte: compare at that resolution
            assert np.array_equal(got >> 8, q8), name
        elif tag == 3:
            # float clips to +-1.0, so -32768 lands on -32767
            assert np.array_equal(got, np.maximum(s16, -32767)), name
        else:
            assert np.array_equal(got, s16), name
        # and the FileSource front door consumes it (3 IQ pairs)
        src = sources.FileSource(p)
        assert src.all().shape == (3,) and src.rate == 48000, name

    bad = tmp_path / "bad.wav"
    _write_wav(bad, s16.tobytes(), 0x55, 2, 48000, 16)
    with pytest.raises(ValueError):
        sources.read_wav(bad)


def test_reference_wav_fixture(sine4410):
    src = sources.FileSource(sine4410["wav"])
    assert src.rate == 44100 and src.channels == 2
    iq = src.all()
    spec = np.fft.fft(iq[:4410])
    peak = np.argmax(np.abs(spec))
    freq = peak if peak < 2205 else peak - 4410
    assert abs(abs(freq) - 441) < 3   # 4410 Hz in a 0.1 s block = bin 441


def test_block_framer():
    f = framer.BlockFramer(100)
    out = list(f.push(np.zeros(250, np.complex64)))
    assert len(out) == 2
    out += list(f.push(np.zeros(60, np.complex64)))
    assert len(out) == 3
    rem = f.flush(pad=True)
    assert rem is not None and len(rem) == 100


def test_config_roundtrip(tmp_path):
    p = tmp_path / "jsdr.properties"
    c = Config(p, overrides=["audio-rate=192000"])
    assert c.get_int("audio-rate", 96000) == 192000
    assert c.get_int("missing", 7) == 7      # default write-back
    c.save()
    c2 = Config(p)
    assert c2.get_int("missing", 0) == 7
    # stale version discarded
    p.write_text("jsdr-tpu-version=999\naudio-rate=1\n")
    c3 = Config(p)
    assert c3.get_int("audio-rate", 96000) == 96000


def test_pubsub_fanout():
    ps = PubSub()
    seen = []
    ps.listen(lambda t, v: seen.append((t, v)))
    ps.publish("fft-psd", 1)
    assert ps.get("fft-psd") == 1 and seen == [("fft-psd", 1)]


def test_stage_timers():
    t = StageTimers()
    with t.stage("convert", samples=1000):
        pass
    rep = t.report()
    assert rep["convert"]["calls"] == 1 and rep["convert"]["samples"] == 1000


def test_state_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    from jsdr_tpu.demod.bpsk import BpskConfig, bpsk_init
    st = bpsk_init(BpskConfig())
    ring = np.asarray(st.ring).copy()
    ring[0] = 1
    st = st._replace(tu_phase=np.float32(1.25), ring=ring)
    f = tmp_path / "st.npz"
    save_state(f, st)
    st2 = load_state(f, bpsk_init(BpskConfig()))
    assert float(st2.tu_phase) == 1.25
    assert int(st2.ring[0]) == 1


def test_state_checkpoint_version_and_config_guards(tmp_path):
    """A checkpoint written under one (n_streams, rate) configuration
    must fail LOUDLY — not silently misload — under another, and
    pre-versioning files are refused (the checkpoint analog of
    jsdr.properties' version-discard, jsdr.java:242-254)."""
    import pytest
    import jax
    from jsdr_tpu.demod.bpsk import BpskConfig, bpsk_init, bpsk_init_batch

    cfg = BpskConfig()
    f = tmp_path / "st.npz"
    save_state(f, bpsk_init_batch(cfg, 4), meta={"rate": 96000})

    # wrong n_streams -> leaf shape mismatch, named in the error
    with pytest.raises(ValueError, match="current configuration"):
        load_state(f, bpsk_init_batch(cfg, 2))
    # wrong declared rate -> meta mismatch
    with pytest.raises(ValueError, match="rate"):
        load_state(f, bpsk_init_batch(cfg, 4),
                   expect_meta={"rate": 192000})
    # meta key the writer never recorded -> refused
    with pytest.raises(ValueError, match="lacks"):
        load_state(f, bpsk_init_batch(cfg, 4), expect_meta={"max_hits": 4})
    # matching config loads fine
    st = load_state(f, bpsk_init_batch(cfg, 4),
                    expect_meta={"rate": 96000})
    assert st.ring.shape == (4, 5199)

    # a different stage layout -> leaf-count mismatch
    with pytest.raises(ValueError, match="leaves"):
        load_state(f, {"telemetry": bpsk_init(cfg),
                       "demod": {"x": np.zeros(3)}})

    # legacy (pre-round-5, unversioned) file -> refused with migration
    # pointer: tu_phase changed units in round 4 (10x NCO numerators)
    leaves, _ = jax.tree.flatten(bpsk_init(cfg))
    legacy = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    g = tmp_path / "legacy.npz"
    np.savez(g, n_leaves=len(leaves), **legacy)
    with pytest.raises(ValueError, match="MIGRATION"):
        load_state(g, bpsk_init(cfg))


def test_wav_malformed_data_chunk(tmp_path):
    """Truncated / ragged WAV data chunks get a clear diagnostic
    (ADVICE r4: raw frombuffer used to throw an unhelpful ValueError),
    and only the FIRST data chunk is read."""
    import struct
    import pytest
    from jsdr_tpu.io.sources import read_wav

    def wav(data: bytes, declared: int | None = None) -> bytes:
        fmt = struct.pack("<HHIIHH", 1, 2, 44100, 44100 * 4, 4, 16)
        d_size = len(data) if declared is None else declared
        body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
                + b"data" + struct.pack("<I", d_size) + data)
        return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body

    # declared size exceeds the file -> descriptive error, not a short read
    p = tmp_path / "trunc.wav"
    p.write_bytes(wav(b"\x01\x00\x02\x00", declared=400))
    with pytest.raises(ValueError, match="truncated data chunk"):
        read_wav(p)

    # ragged tail byte is trimmed to a whole sample width
    p2 = tmp_path / "ragged.wav"
    p2.write_bytes(wav(b"\x01\x00\x02\x00\x7f"))
    s16, ch, rate = read_wav(p2)
    assert list(s16) == [1, 2] and ch == 2 and rate == 44100

    # a (non-spec) second data chunk is ignored: first one wins
    extra = b"data" + struct.pack("<I", 4) + b"\x09\x00\x0a\x00"
    p3 = tmp_path / "twodata.wav"
    p3.write_bytes(wav(b"\x03\x00\x04\x00") + extra)
    s16, _, _ = read_wav(p3)
    assert list(s16) == [3, 4]


def test_fcd_degrades_without_binary():
    fcd = FCD(binary=None)
    assert not fcd.available()
    assert fcd.default_rate() == 96000


def test_display_reductions(rng):
    from jsdr_tpu.display import Waterfall, phase_scope_data, render_psd_ascii
    psd = rng.uniform(-100, -10, 1024)
    wf = Waterfall(width=256, height=8)
    wf.push(psd)
    assert wf.buf[0].max() > 0
    top = wf.buf[0].copy()
    wf.push(psd * 0)
    assert np.array_equal(wf.buf[1], top)   # scrolled down
    iq = sources.synth_sine(4410, 441.0, 44100.0)
    ps = phase_scope_data(iq, width=64)
    assert ps.points.shape == (64, 2) and 0.4 < ps.max_abs < 0.6
    art = render_psd_ascii(psd, width=64, height=10)
    assert len(art.splitlines()) == 10


def test_streaming_executor_session(rng):
    from jsdr_tpu.demod.bpsk import BpskConfig
    from jsdr_tpu.io.sources import synth_bpsk_stream
    from jsdr_tpu.runtime.executor import Session, SpectrumStage, TelemetryStage

    payload = np.arange(256, dtype=np.uint8)[None]
    sig = synth_bpsk_stream(payload, rate=96000, preamble_bits=300)
    sig = np.concatenate([sig, np.zeros((-len(sig)) % 96000, np.complex64)])

    def chunks():
        for i in range(0, len(sig), 48000):
            yield sig[i:i + 48000]

    frames, psds = [], []
    s = Session(source=chunks(), block_samples=96000)
    s.pubsub.listen(lambda t, v: frames.append(v) if t == "telemetry-frame"
                    else psds.append(v) if t == "fft-psd" else None)
    n = s.run([SpectrumStage(96000),
               TelemetryStage(BpskConfig(rate=96000, tuning=12000.0))])
    assert n == len(sig) // 96000
    assert len(psds) == n
    assert len(frames) == 1 and frames[0]["ok"]
    assert np.array_equal(frames[0]["payload"], payload[0])
    rep = s.timers.report()
    assert rep["telemetry"]["samples"] == n * 96000


def test_device_side_conversion_matches_host(rng):
    import jax.numpy as jnp
    from jsdr_tpu.io.convert_device import s16_to_cf, upload_raw
    from jsdr_tpu.ops.cplx import to_complex
    s = rng.integers(-32768, 32768, 4096, dtype=np.int16)
    dev = to_complex(s16_to_cf(upload_raw(s), jnp.int32(3), jnp.int32(-5)))
    host = convert.s16le_to_complex(s, 2, 3, -5)
    assert np.array_equal(dev, host)
    # wrap-around parity: corrections that overflow Java short arithmetic
    big = np.full(64, 32000, dtype=np.int16)
    dev = to_complex(s16_to_cf(upload_raw(big), jnp.int32(2000), jnp.int32(-40000)))
    host = convert.s16le_to_complex(big, 2, 2000, -40000)
    assert np.array_equal(dev, host)
    # mono maps to Q=0 (JavaAudio.java:49-57 mono path)
    mono = rng.integers(-32768, 32768, 128, dtype=np.int16)
    dev = to_complex(s16_to_cf(upload_raw(mono), jnp.int32(0), jnp.int32(0),
                               channels=1))
    host = convert.s16le_to_complex(mono, 1, 0, 0)
    assert np.array_equal(dev, host)


def test_executor_retry_restores_state_and_counts_drops(rng):
    """A failing stage must (a) retry against the state it started the
    block with — not state advanced by the failed attempt — and (b) on a
    double failure restore state, count the drop, and publish a gap
    marker (fixes the silent-skip/reprocess hazard of the retry loop)."""
    from jsdr_tpu.runtime.executor import Session, Stage

    sig = sources.synth_noise(4 * 1024, seed=0)

    class FlakyStage(Stage):
        name = "flaky"

        def __init__(self):
            self.state = 0
            self.calls = 0

        def process(self, block, session):
            self.calls += 1
            start = self.state
            self.state = start + 1          # advance BEFORE failing
            if self.calls == 2:             # first attempt at block 1 dies
                raise RuntimeError("transient")

    class DeadStage(Stage):
        name = "dead"

        def __init__(self):
            self.state = 123

        def process(self, block, session):
            self.state = 999
            raise RuntimeError("always")

    markers = []
    flaky, dead = FlakyStage(), DeadStage()
    s = Session(source=iter([sig]), block_samples=1024)
    s.pubsub.listen(lambda t, v: markers.append(v) if t == "dropped-block" else None)
    n = s.run([flaky, dead])
    assert n == 4
    # flaky: 4 blocks + 1 retry = 5 calls; retry saw the pre-attempt state,
    # so state advanced exactly once per block
    assert flaky.calls == 5
    assert flaky.state == 4
    # dead: every block dropped, state never corrupted by failed attempts
    assert dead.state == 123
    assert s.dropped_blocks == {"dead": 4}
    assert [m["block"] for m in markers] == [0, 1, 2, 3]
    assert markers[-1]["total"] == 4


def test_spectrum_overlays_and_waterfall_peak_color(tmp_path, rng):
    """Display-overlay parity: filter band region (fft.java:98-106),
    dB/freq reticle (fft.java:108-128), tuning bars (fft.java:152-173),
    waterfall peak-color law (waterfall.java:100-104)."""
    import zlib
    from jsdr_tpu.display import (Waterfall, render_spectrum_png,
                                  render_waterfall_png)

    def read_png_rgb(path):
        data = path.read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        w = int.from_bytes(data[16:20], "big")
        h = int.from_bytes(data[20:24], "big")
        assert data[25] == 2                      # color type RGB
        idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 4]
        raw = zlib.decompress(idat)
        rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * 3)
        assert np.all(rows[:, 0] == 0)
        return rows[:, 1:].reshape(h, w, 3)

    psd = rng.uniform(-95.0, -60.0, 9600).astype(np.float32)
    p = tmp_path / "spec.png"
    render_spectrum_png(p, psd, rate=96000, filter_band=(-3000, 3000),
                        tunings=(12000,), centre_bins=(204,),
                        width=640, height=320)
    img = read_png_rgb(p)
    off = 320
    # filter band: +/-3000 Hz -> 20 px either side of centre, tcol fill
    x_in = off - 10
    assert tuple(img[0, x_in]) == (0x1F, 0x1F, 0x00)
    # tuning bar at 12 kHz -> x = 640*12000/96000 + off = 400, full height
    assert np.all(img[:, 400] == (0, 255, 255))
    # centre bar at bin 204, step = 9600/640 = 15 -> x = 13 + off
    assert np.all(img[:, off + 13] == (0, 255, 255))
    # dB reticle line at height/10
    assert tuple(img[32, 4]) == (0x40, 0x40, 0x40)
    # the PSD trace put green somewhere on most columns
    green = (img[:, :, 1] == 255) & (img[:, :, 0] == 0) & (img[:, :, 2] == 255)
    # (exclude cyan: green channel alone)
    trace = (img == np.array([0, 255, 0])).all(-1)
    assert trace.any(axis=0).mean() > 0.9

    wf = Waterfall(width=64, height=4)
    wf.push(psd[:64] * 0 - 50.0)                  # flat -50 dB line
    p2 = tmp_path / "wf.png"
    render_waterfall_png(p2, wf.buf)              # default CYAN peak
    img2 = read_png_rgb(p2)
    inten = int(np.clip(255 - (-50.0) * -2.55, 0, 255))   # 127
    assert tuple(img2[0, 0]) == (0, 255 * inten // 256, 255 * inten // 256)
    assert tuple(img2[1, 0]) == (0, 0, 0)         # scrolled rows empty


def test_fcd_capture_source(tmp_path):
    """FCD.capture_source finds the dongle's ALSA card and builds a
    live capture spec (FCD.getLine analog, FCD.java:235-259)."""
    cards = tmp_path / "cards"
    cards.write_text(
        " 0 [PCH    ]: HDA-Intel - HDA Intel PCH\n"
        " 2 [V20    ]: USB-Audio - FUNcube Dongle V2.0\n")
    fcd = FCD(binary=None)
    spec = fcd.capture_source(rate=96000, cards_path=str(cards))
    assert spec == ("capture:arecord -D hw:2,0 -f S16_LE -r 96000 "
                    "-c 2 -t raw")
    cards.write_text(" 0 [PCH    ]: HDA-Intel - HDA Intel PCH\n")
    assert fcd.capture_source(cards_path=str(cards)) is None
    assert fcd.capture_source(cards_path=str(tmp_path / "nope")) is None


def test_recorder_stage_roundtrip(tmp_path):
    """RecorderStage must write replayable S16LE IQ: a recorded session
    re-opened as a FileSource yields the same samples (recorder.java's
    fixture-producing role)."""
    from jsdr_tpu.io.sources import FileSource, synth_sine
    from jsdr_tpu.runtime.executor import RecorderStage, Session

    iq = synth_sine(4800, 1000.0, 9600.0, amplitude=0.5)
    path = tmp_path / "cap.raw"
    stage = RecorderStage(path)
    session = Session(source=iter([iq]), block_samples=960)
    n = session.run([stage])
    stage.close()
    assert n == 5
    back = FileSource(path, rate=9600).all()
    assert len(back) == 4800
    # S16 quantization bound: 1/32767 per component
    np.testing.assert_allclose(back.real, iq[:4800].real, atol=1.01 / 32767)
    np.testing.assert_allclose(back.imag, iq[:4800].imag, atol=1.01 / 32767)


def test_raw_session_device_convert_and_raw_record_tap(tmp_path, rng):
    """Raw-mode Session: int16 chunks convert ON DEVICE with ic/qc
    corrections (JavaAudio.java:275-293), the recorder taps the
    PRE-conversion bytes (recorder.java:66-74 IRawHandler semantics) so
    the recorded file is byte-identical to the capture even with
    nonzero corrections — the round-trip the converted-tap path
    provably breaks."""
    from jsdr_tpu.io.sources import FileSource
    from jsdr_tpu.runtime.executor import RecorderStage, Session, Stage

    data = rng.integers(-32768, 32768, 2 * 4800, dtype=np.int16)
    cap = tmp_path / "cap.raw"
    cap.write_bytes(data.astype("<i2").tobytes())

    src = FileSource(cap, rate=9600)
    seen = []

    class Probe(Stage):
        name = "probe"

        def process(self, block, session):
            seen.append((np.asarray(block.re), np.asarray(block.im)))

    rec = RecorderStage(tmp_path / "rec.raw")
    session = Session(source=src.raw_blocks(960), block_samples=960,
                      i_corr=2, q_corr=-5)
    n = session.run([Probe(), rec])
    rec.close()
    assert n == 5
    # recorded file == capture bytes exactly, despite ic/qc corrections
    assert (tmp_path / "rec.raw").read_bytes() == cap.read_bytes()
    # device-converted planes match the host converter WITH corrections
    host = convert.s16le_to_complex(data, 2, 2, -5)
    got = np.concatenate([r + 1j * q for r, q in seen]).astype(np.complex64)
    assert np.array_equal(got, host.astype(np.complex64))


def test_telemetry_sync_every_defers_readbacks(rng):
    """TelemetryStage must NOT sync the device every block: counters
    publish once per sync_every-block drain (+ the finish flush) and
    frames still come out (at most sync_every blocks late)."""
    from jsdr_tpu.demod.bpsk import BpskConfig
    from jsdr_tpu.io.sources import synth_bpsk_stream
    from jsdr_tpu.runtime.executor import Session, TelemetryStage

    payload = np.arange(256, dtype=np.uint8)[None]
    sig = synth_bpsk_stream(payload, rate=96000, preamble_bits=300)
    sig = np.concatenate([sig, np.zeros((-len(sig)) % 96000, np.complex64)])
    n_blocks = len(sig) // 96000

    frames, counter_pubs = [], []
    s = Session(source=iter([sig]), block_samples=96000)
    s.pubsub.listen(lambda t, v: frames.append(v) if t == "telemetry-frame"
                    else counter_pubs.append(v) if t == "telemetry-counters"
                    else None)
    stage = TelemetryStage(BpskConfig(rate=96000, tuning=12000.0),
                           sync_every=3)
    n = s.run([stage])
    assert n == n_blocks
    # drains: one per full 3-block group + the finish() flush
    assert len(counter_pubs) == -(-n_blocks // 3)
    assert len(frames) == 1 and frames[0]["ok"]
    assert np.array_equal(frames[0]["payload"], payload[0])


def test_spectrum_telemetry_stage_one_pass(rng):
    """SpectrumTelemetryStage (merged one-input-read device step) must
    deliver both display topics (waterfall-line, fft-peak) and decoded
    frames, matching the separate SpectrumStage+TelemetryStage pair's
    telemetry results."""
    from jsdr_tpu.demod.bpsk import BpskConfig
    from jsdr_tpu.io.sources import synth_bpsk_stream
    from jsdr_tpu.runtime.executor import Session, SpectrumTelemetryStage

    payload = np.arange(256, dtype=np.uint8)[None]
    sig = synth_bpsk_stream(payload, rate=96000, preamble_bits=300)
    sig = np.concatenate([sig, np.zeros((-len(sig)) % 96000, np.complex64)])

    frames, lines, peaks = [], [], []
    s = Session(source=iter([sig]), block_samples=96000)
    s.pubsub.listen(lambda t, v: frames.append(v) if t == "telemetry-frame"
                    else lines.append(v) if t == "waterfall-line"
                    else peaks.append(v) if t == "fft-peak" else None)
    stage = SpectrumTelemetryStage(BpskConfig(rate=96000, tuning=12000.0),
                                   sync_every=2)
    n = s.run([stage])
    assert n == len(sig) // 96000
    assert len(frames) == 1 and frames[0]["ok"]
    assert np.array_equal(frames[0]["payload"], payload[0])
    assert lines and lines[0].shape == (10, 1920)   # 10 blocks/s, 1920 px
    # the BPSK carrier sits at 12 kHz + 1200 Hz
    assert any(abs(p[0] - 13200) < 1300 for p in peaks)


def test_compile_cache_dir(monkeypatch, tmp_path):
    """init_compile_cache leaves an exported JAX_COMPILATION_CACHE_DIR
    to JAX and otherwise pins the cache to <repo>/.jax_cache."""
    from pathlib import Path

    import jax
    from jsdr_tpu.runtime.device import init_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert init_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        want = str(Path(__file__).resolve().parents[1] / ".jax_cache")
        assert init_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
