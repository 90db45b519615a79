"""Benchmark: IQ Msamples/s per card through the FFT+FIR+BPSK telemetry
chain, plus FEC, ingest, 192 kS/s, auto-tune, WFM and live-session phases.

Measures the flagship pipeline on one card: batched display spectrum
(windowed matmul FFT + PSD -> display-decimated waterfall lines + exact
peak search, fft.java + waterfall.java analog) plus the full FUNcube
telemetry front end (tuner mix -> 27-tap decimating FIR -> VCO + 65-tap
matched filter -> parallel timing recovery -> stride-80 sync correlation
-> soft-window extraction) over a batch of independent streams, as one
jitted step (demod.bpsk.bpsk_block_batch_spectrum).

Methodology: the input batch is uploaded once and stays on the device;
the timed step consumes it end-to-end with every output forced (sums of
all result tensors) and each timing ends in ``block_until_ready``. Two
timings are reported: one dispatch per step, and steady state (10 steps
chained in one jit via lax.fori_loop). The chained loop must defeat
XLA's while-loop invariant code motion: with a CONSTANT input, any op
that depends only on the input (the whole display spectrum — it carries
no state) is hoisted out of the loop and runs ONCE for k steps. The
input buffer is therefore loop-CARRIED and one sample is overwritten
with a state-derived value each iteration (an in-place
dynamic-update-slice), so every op executes every iteration, exactly as
with streamed fresh input. The loop-carried demod state keeps the
telemetry chain live, and every output tensor is reduced into the carry
(no dead-code elimination).

Baseline: the reference is a real-time desktop app designed for at most
192 kS/s (FCD V2, jsdr.java:271-277) on one CPU — no published numbers
exist (BASELINE.md), so vs_baseline = Msps / 0.192.

Needs a GPU: there is no CPU fallback, and any failed phase fails the
run. Prints ONE JSON line on stdout; diagnostics go to stderr.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_info() -> str:
    """The card's name and power limit, from a child process that does
    not touch JAX (nvidia-smi's own csv line)."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def bench_fec(log):
    """Timed batched AO-40 fec_decode (deinterleave -> Viterbi -> RS x2 ->
    re-encode + error count), the decode tail that runs per detected
    frame (FECDecoder.java:703-852 work unit). Chain budget: one frame
    per stream per ~4.33 s (5200 symbols at 1200 bps), i.e. 0.23
    frames/s/stream — the frames/s here is how many concurrent streams'
    decode tails one card absorbs."""
    import jax
    import jax.numpy as jnp
    from jsdr_tpu.fec.decoder import fec_decode
    from jsdr_tpu.fec.ref_numpy import encode_fec40, symbols_to_soft

    rng = np.random.default_rng(1)
    base_payloads = rng.integers(0, 256, (64, 256), dtype=np.uint8)
    base = np.stack([symbols_to_soft(encode_fec40(p))
                     for p in base_payloads])
    for batch in (64, 256, 1024):
        raws = np.tile(base, (batch // 64, 1))
        for r in raws:   # ~2.3% channel symbol errors: real ACS/BM work
            r[rng.choice(5200, 120, replace=False)] ^= 0x80
        x = jax.device_put(jnp.asarray(raws, dtype=jnp.uint8))
        t0 = time.time()
        res = jax.block_until_ready(fec_decode(x))
        ok = int(res.ok.sum())
        t_compile = time.time() - t0
        iters = 10

        # CHAIN the iterations: each step's input perturbation depends on
        # the previous step's result, so no two dispatches are identical
        # (the carry strictly grows) and the final wait covers them all
        @jax.jit
        def step(x, c):
            x = x.at[0, 0].set(
                ((x[0, 0].astype(jnp.int32) + c) % 256).astype(jnp.uint8))
            r = fec_decode(x)
            return r.ok.sum(), r.rc.sum() + c

        jax.block_until_ready(step(x, jnp.int32(0)))
        c = jnp.int32(1)
        t0 = time.time()
        for _ in range(iters):
            res = step(x, c)
            c = res[1]
        jax.block_until_ready(c)
        dt = (time.time() - t0) / iters
        log(f"fec_decode batch={batch}: {dt*1000:.1f} ms -> "
            f"{batch/dt:.0f} frames/s ({ok}/{batch} ok, 120 chan errs each; "
            f"compile+first {t_compile:.1f}s) -> headroom ~"
            f"{batch/dt/0.231:.0f} realtime streams/card")


def bench_ingest(log):
    """Ingest-path comparison: raw int16 upload + on-device planar convert
    (io/convert_device.s16_to_cf — EXACTLY what the streaming Session's
    raw-mode h2d stage runs, runtime/executor.py Session.run) vs
    host-side convert + planar float32 upload. Device convert halves the
    transferred bytes and moves the scale/DC loop onto the device."""
    import jax
    import jax.numpy as jnp
    from jsdr_tpu.io.convert import s16le_to_complex
    from jsdr_tpu.io.convert_device import s16_to_cf
    from jsdr_tpu.ops.cplx import from_complex

    rng = np.random.default_rng(2)
    n = 4_800_000                       # 50 s at 96k: 19.2 MB of S16LE
    s16 = rng.integers(-32768, 32768, 2 * n, dtype=np.int16)
    ic, qc = jnp.int32(3), jnp.int32(-5)

    dev = jax.block_until_ready(               # warm both paths
        s16_to_cf(jax.device_put(s16), ic, qc))
    host_ref = s16le_to_complex(s16, 2, 3, -5)
    import numpy as _np
    assert _np.array_equal(_np.asarray(dev.re), host_ref.real), \
        "device convert mismatch"
    log(f"ingest (Session raw-mode h2d path): device convert verified on "
        f"{jax.devices()[0].platform} backend")

    iters = 3
    t0 = time.time()
    for _ in range(iters):
        jax.block_until_ready(s16_to_cf(jax.device_put(s16), ic, qc))
    dt_dev = (time.time() - t0) / iters
    t0 = time.time()
    for _ in range(iters):
        host = s16le_to_complex(s16, 2, 3, -5)
        jax.block_until_ready(jax.device_put(from_complex(host)))
    dt_host = (time.time() - t0) / iters
    mb = s16.nbytes / 1e6
    log(f"ingest {n/1e6:.1f}M samples ({mb:.0f} MB raw): "
        f"int16 upload + device convert {dt_dev*1000:.0f} ms "
        f"({n/dt_dev/1e6:.1f} MS/s) vs host convert + float upload "
        f"{dt_host*1000:.0f} ms ({n/dt_host/1e6:.1f} MS/s) "
        f"-> device path {dt_host/dt_dev:.2f}x")


def bench_192k(log):
    """Full chain at the FCD V2 rate (192 kS/s, decim=20 —
    jsdr.java:271-277): the second hardware configuration the reference
    supports. Same methodology as the headline number."""
    import jax
    import jax.numpy as jnp
    from jsdr_tpu.demod.bpsk import BpskConfig, bpsk_block_batch_spectrum, \
        bpsk_init_batch
    from jsdr_tpu.io.sources import synth_bpsk_stream
    from jsdr_tpu.ops.cplx import CF, from_complex

    # 256 streams x 2.4 s: the same sample count per step as the 96 k
    # shape. The hoist-proof chained form (see main) is the headline.
    rate, n_streams, t_len = 192_000, 256, 460_800      # 2.4 s per stream
    cfg = BpskConfig(rate=rate, tuning=12_000.0)
    rng = np.random.default_rng(3)
    base = synth_bpsk_stream(
        rng.integers(0, 256, (1, 256), dtype=np.uint8),
        rate=rate, preamble_bits=400, noise_rms=0.3)
    reps = int(np.ceil(n_streams * t_len / len(base)))
    sig = np.tile(base, reps)[: n_streams * t_len].reshape(n_streams, t_len)
    iq = jax.block_until_ready(jax.device_put(from_complex(sig)))
    states = jax.block_until_ready(
        jax.device_put(bpsk_init_batch(cfg, n_streams)))

    # decode-liveness proof FIRST: a 4.33 s frame is 833k samples at
    # 192 k, so the timed loops' per-stream 2.4 s periodic window can
    # never contain one — hits=0 in the timed loops is EXPECTED there.
    # Chain the step over a CONTINUOUS 3x2.4 s slice of the signal and
    # require a sync hit.
    live_st = jax.device_put(bpsk_init_batch(cfg, 1))
    cont = np.tile(base, int(np.ceil(3 * t_len / len(base))))[:3 * t_len]
    hits_live = 0
    for seg in range(3):
        _, lo, live_st = bpsk_block_batch_spectrum(
            from_complex(cont[None, seg * t_len:(seg + 1) * t_len]),
            cfg, live_st)
        hits_live += int(jax.block_until_ready(lo.n_hits)[0])
    assert hits_live >= 1, "192k chain failed to decode"
    log(f"192 kS/s decode liveness: {hits_live} sync hit(s) over a "
        f"continuous 7.2 s chained stream")

    @jax.jit
    def step(iq, states):
        spec, out, new_states = bpsk_block_batch_spectrum(iq, cfg, states)
        forced = (spec.wf.sum() + spec.peak_db.sum()
                  + out.windows.astype(jnp.int32).sum()
                  + out.hit_corr.sum() + out.n_hits.sum() + out.n_bits.sum())
        return forced, out.n_hits.sum(), new_states

    res = jax.block_until_ready(step(iq, states))
    iters, st = 10, states
    t0 = time.time()
    for _ in range(iters):
        out = step(iq, st)
        st = out[2]
    jax.block_until_ready(out)
    dt = (time.time() - t0) / iters
    msps = n_streams * t_len / dt / 1e6
    log(f"192 kS/s (FCD V2, decim=20) chain: {msps:.0f} MS/s/card "
        f"({dt*1000:.1f} ms/step, hits={int(res[1])}) "
        f"-> {msps/0.192:.0f}x the reference V2 real-time rate")

    k_chain = 10

    @jax.jit
    def chained(iq_re, iq_im, states):
        # hoist-proof carried-buffer form (see main's chained docstring)
        def body(_, carry):
            acc, re_buf, st = carry
            spec, out, st = bpsk_block_batch_spectrum(
                CF(re_buf, iq_im), cfg, st)
            forced = (spec.wf.sum() + spec.peak_db.sum()
                      + spec.peak_freq.sum()
                      + out.windows.astype(jnp.int32).sum()
                      + out.hit_corr.sum() + out.n_hits.sum()
                      + out.n_bits.sum()).astype(jnp.float32)
            re_buf = jax.lax.dynamic_update_slice(
                re_buf, (forced * 1e-12)[None, None], (0, 0))
            return acc + forced, re_buf, st
        return jax.lax.fori_loop(
            0, k_chain, body, (jnp.float32(0.0), iq_re, states))

    jax.block_until_ready(chained(iq.re, iq.im, states))
    m, stc = 2, states
    t0 = time.time()
    for _ in range(m):
        acc, _, stc = chained(iq.re, iq.im, stc)
    jax.block_until_ready((acc, stc))
    dt_c = (time.time() - t0) / (m * k_chain)
    msps_c = n_streams * t_len / dt_c / 1e6
    hits_c = int(np.asarray(stc.counters)[:, 3].sum())
    log(f"192 kS/s steady-state ({m}x{k_chain} chained steps, "
        f"hoist-proof): {dt_c*1000:.2f} ms/step -> {msps_c:.0f} MS/s/card "
        f"sustained (cumulative hits={hits_c}; 0 expected — the periodic "
        f"2.4 s window cannot contain a 4.33 s frame, see the liveness "
        f"line above)")


def bench_dofft(log):
    """FFT auto-tune (dofft) front end: decode liveness for a carrier
    the chain was never told about (doBufferFFT at speed,
    FUNcubeBPSKDemod.java:406-464), then the step cost of the auto-tuned
    path vs the manual path at the same bench shape."""
    import jax
    import jax.numpy as jnp
    from jsdr_tpu.demod.bpsk import (BpskConfig, bpsk_block_batch,
                                     bpsk_block_batch_spectrum,
                                     bpsk_init_batch)
    from jsdr_tpu.io.sources import synth_bpsk_stream
    from jsdr_tpu.ops.cplx import from_complex

    rate, n_streams, t_len = 96_000, 128, 460_800   # the headline shape
    rng = np.random.default_rng(5)
    base = synth_bpsk_stream(
        rng.integers(0, 256, (1, 256), dtype=np.uint8), rate=rate,
        carrier_offset=11_900.0, preamble_bits=400, noise_rms=0.3)

    # decode liveness: two chained continuous segments, ONE auto-tuned
    # stream, no tuning given — the tuner must find the 11.9 kHz+1.2 kHz
    # carrier itself and the chain must produce a sync hit
    cfg_d = BpskConfig(rate=rate, dofft=True)
    cont = np.tile(base, int(np.ceil(2 * t_len / len(base))))[: 2 * t_len]
    live_st = jax.device_put(bpsk_init_batch(cfg_d, 1))
    hits_live = 0
    for seg in range(2):
        lo, live_st = bpsk_block_batch(
            from_complex(cont[None, seg * t_len:(seg + 1) * t_len]),
            cfg_d, live_st)
        hits_live += int(jax.block_until_ready(lo.n_hits)[0])
    centre = int(np.asarray(live_st.fft_tuner.centre_bin)[0])
    assert hits_live >= 1, f"dofft chain failed to decode (centre={centre})"
    assert abs(centre - 1310) < 30, centre
    log(f"dofft decode liveness: {hits_live} sync hit(s), tuner locked "
        f"centre_bin={centre} (carrier bin 1310) over a continuous "
        f"9.6 s auto-tuned stream")

    reps = int(np.ceil(n_streams * t_len / len(base)))
    sig = np.tile(base, reps)[: n_streams * t_len].reshape(n_streams, t_len)
    iq = jax.block_until_ready(jax.device_put(from_complex(sig)))

    def timed(cfg):
        @jax.jit
        def step(iq, states):
            spec, out, st = bpsk_block_batch_spectrum(iq, cfg, states)
            forced = (spec.wf.sum() + spec.peak_db.sum()
                      + spec.peak_freq.sum()
                      + out.windows.astype(jnp.int32).sum()
                      + out.hit_corr.sum() + out.n_hits.sum()
                      + out.n_bits.sum())
            return forced, st

        st = jax.device_put(bpsk_init_batch(cfg, n_streams))
        jax.block_until_ready(step(iq, st))
        iters = 10
        t0 = time.time()
        for _ in range(iters):
            out = step(iq, st)
            st = out[1]
        jax.block_until_ready(out)
        return (time.time() - t0) / iters

    dt_d = timed(cfg_d)
    dt_m = timed(BpskConfig(rate=rate, tuning=12_000.0))
    msps_d = n_streams * t_len / dt_d / 1e6
    log(f"dofft: {dt_d*1000:.2f} ms/step -> "
        f"{msps_d:.0f} MS/s/card at {n_streams}x4.8s vs manual "
        f"{dt_m*1000:.2f} ms/step ({dt_d/dt_m:.2f}x — the auto-tuner's "
        f"per-0.1s forward FFT + slice/iDFT-matmul emit + EMA "
        f"recurrence)")


def bench_live_soak(log):
    """60 s PACED live session — the production loop end-to-end: raw
    int16 chunks delivered at real time (PacedSource deadline pacing,
    JavaAudio.java:231-233 semantics), device-side convert (the raw-mode
    h2d path), full telemetry chain, batched readbacks (sync_every=8),
    frame decode via the pub/sub drain. Reports wall/realtime ratio,
    busy fraction (margin), dropped blocks, and decoded frames — the
    proof that the production Session sustains real time with margin."""
    import jax
    from jsdr_tpu.demod.bpsk import BpskConfig
    from jsdr_tpu.io.convert import complex_to_s16le
    from jsdr_tpu.io.live import PacedSource
    from jsdr_tpu.io.sources import synth_bpsk_stream
    from jsdr_tpu.runtime.executor import Session, TelemetryStage

    rate, secs = 96_000, 60
    rng = np.random.default_rng(7)
    base = synth_bpsk_stream(
        rng.integers(0, 256, (1, 256), dtype=np.uint8),
        rate=rate, preamble_bits=600, noise_rms=0.25)
    reps = int(np.ceil(secs * rate / len(base)))
    sig = np.tile(base, reps)[: secs * rate]
    raw = np.frombuffer(complex_to_s16le(sig), "<i2")
    chunks = [raw[i * 2 * rate:(i + 1) * 2 * rate] for i in range(secs)]
    expect_frames = secs * rate // len(base)

    def make(source):
        cfg = BpskConfig(rate=rate, max_hits_per_block=2)
        stage = TelemetryStage(cfg, tunings=[12000.0], sync_every=8)
        sess = Session(source=source, block_samples=rate)
        frames = []
        sess.pubsub.listen(lambda t, v: frames.append(v)
                           if t == "telemetry-frame" else None)
        return sess, stage, frames

    # warm the compile cache so the soak measures steady state
    sess_w, stage_w, _ = make(iter(chunks[:2]))
    sess_w.run([stage_w])

    sess, stage, frames = make(PacedSource(iter(chunks), rate))
    t0 = time.time()
    n = sess.run([stage])
    wall = time.time() - t0
    rep = sess.timers.report()
    busy = sum(v["wall_s"] for v in rep.values())
    ok = sum(1 for f in frames if f.get("ok"))
    drops = sum(sess.dropped_blocks.values())
    assert drops == 0, f"live soak dropped blocks: {sess.dropped_blocks}"
    log(f"live soak: {secs} s paced raw-mode session, {n} blocks in "
        f"{wall:.1f} s wall (x{secs/wall:.3f} realtime), busy "
        f"{busy:.1f} s ({busy/wall*100:.0f}% -> {1-busy/wall:.0%} idle "
        f"margin), drops={drops}, frames decoded={ok}/{expect_frames}")


def bench_demod(log):
    """Broadcast-audio demod at full rate (demod.java:398-483 work unit):
    21-tap complex band-pass FIR + NCO down-shift + quadrature
    discriminator + AGC, WFM mode, batched over streams — the
    reference's configs 2-3 (AM/NFM/WFM to speaker audio)."""
    import jax
    import jax.numpy as jnp
    from jsdr_tpu.demod.am_fm import AmFmConfig, AmFmState, Mode, demod_block
    from jsdr_tpu.ops.cplx import CF, from_complex

    rate, n_streams, t_len = 96_000, 64, 960_000      # 10 s per stream
    cfg = AmFmConfig(rate=rate, mode=int(Mode.WFM), dofir=True,
                     dodwn=True, doagc=True, flo=-20_000, fhi=20_000)
    rng = np.random.default_rng(4)
    sig = (0.3 * (rng.standard_normal((n_streams, t_len))
                  + 1j * rng.standard_normal((n_streams, t_len)))
           ).astype(np.complex64)
    iq = jax.block_until_ready(jax.device_put(from_complex(sig)))
    st0 = AmFmState.init(cfg)
    states = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x),
                                  (n_streams, *np.shape(x))).copy(), st0)
    states = jax.block_until_ready(jax.device_put(states))

    # the WFM carried state hits an exact FIXED POINT on repeated
    # identical input (delta = n*phi mod 2pi lands on 0 for these
    # shapes); feed a per-iteration counter into one input sample so
    # every dispatch is genuinely distinct
    @jax.jit
    def step(re, im, st, i):
        re = jax.lax.dynamic_update_slice(
            re, (i.astype(jnp.float32) * 1e-9)[None, None], (0, 0))
        f = lambda iq1, st1: demod_block(iq1, cfg, st1)
        audio, mx, avg, ns = jax.vmap(f)(CF(re, im), st)
        return audio.sum() + mx.sum(), ns

    res = jax.block_until_ready(step(iq.re, iq.im, states, jnp.int32(0)))
    iters, st = 10, states
    t0 = time.time()
    for i in range(iters):
        out = step(iq.re, iq.im, st, jnp.int32(i + 1))
        st = out[1]
    jax.block_until_ready(out)
    dt = (time.time() - t0) / iters
    msps = n_streams * t_len / dt / 1e6
    log(f"WFM demod (FIR+downshift+discriminator+AGC): {msps:.0f} MS/s/card "
        f"({dt*1000:.1f} ms/step) -> ~{msps/0.096:.0f} realtime 96k "
        f"broadcast channels/card")


def main():
    import jax
    import jax.numpy as jnp
    from jsdr_tpu.demod.bpsk import (BpskConfig, bpsk_block_batch_spectrum,
                                     bpsk_init_batch)
    from jsdr_tpu.io.sources import synth_bpsk_stream
    from jsdr_tpu.ops.cplx import CF, from_complex
    from jsdr_tpu.runtime.device import init_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    card = card_info()
    log(f"device: {dev.device_kind} x{len(jax.devices())}; "
        f"card (name, power limit): {card}")
    log(f"compilation cache: {init_compile_cache()}")

    # 128 streams x 4.8 s at 96 kS/s per step
    n_streams = 128
    t_len = 460_800                      # 4.8 s per stream at 96 kS/s
    rate = 96_000
    cfg = BpskConfig(rate=rate, tuning=12_000.0)

    rng = np.random.default_rng(0)
    base = synth_bpsk_stream(
        rng.integers(0, 256, (2, 256), dtype=np.uint8),
        rate=rate, preamble_bits=400, noise_rms=0.3)
    reps = int(np.ceil(n_streams * t_len / len(base)))
    sig = np.tile(base, reps)[: n_streams * t_len].reshape(n_streams, t_len)

    t0 = time.time()
    iq = jax.block_until_ready(jax.device_put(from_complex(sig)))
    states = jax.block_until_ready(
        jax.device_put(bpsk_init_batch(cfg, n_streams)))
    up = time.time() - t0
    log(f"one-time upload: {sig.nbytes/1e6:.0f} MB in {up:.1f}s")

    @jax.jit
    def step(iq, states):
        spec, out, new_states = bpsk_block_batch_spectrum(iq, cfg, states)
        # force every output tensor (no DCE of the windows/sync path)
        forced = (spec.wf.sum() + spec.peak_db.sum()
                  + spec.peak_freq.sum()
                  + out.windows.astype(jnp.int32).sum()
                  + out.hit_corr.sum() + out.n_hits.sum() + out.n_bits.sum())
        return forced, out.n_hits.sum(), out.n_bits.sum(), new_states

    log("compiling + first run...")
    t0 = time.time()
    res = jax.block_until_ready(step(iq, states))
    log(f"compile+first run: {time.time()-t0:.1f}s; "
        f"bits={int(res[2])} hits={int(res[1])}")

    iters = 20
    st = states
    t0 = time.time()
    for _ in range(iters):
        out = step(iq, st)
        st = out[3]
    jax.block_until_ready(out)
    total = time.time() - t0
    per_step = total / iters
    samples = n_streams * t_len
    msps = samples / per_step / 1e6
    log(f"{iters} steps in {total:.3f}s -> {per_step*1000:.2f} ms/step "
        f"for {samples/1e6:.1f}M samples (one dispatch per step)")

    # Steady state: k dependent steps inside ONE jit (lax.fori_loop),
    # hoist-proof (see the module docstring): the input's real plane
    # rides the loop carry and one sample is overwritten with a
    # state-derived value each iteration, the demod state advances every
    # iteration and every output reduces into the f32 carry (no DCE).
    k_chain = 10

    @jax.jit
    def chained(iq_re, iq_im, states):
        def body(_, carry):
            acc, re_buf, st = carry
            spec, out, st = bpsk_block_batch_spectrum(
                CF(re_buf, iq_im), cfg, st)
            forced = (spec.wf.sum() + spec.peak_db.sum()
                      + spec.peak_freq.sum()
                      + out.windows.astype(jnp.int32).sum()
                      + out.hit_corr.sum() + out.n_hits.sum()
                      + out.n_bits.sum()).astype(jnp.float32)
            re_buf = jax.lax.dynamic_update_slice(
                re_buf, (forced * 1e-12)[None, None], (0, 0))
            return acc + forced, re_buf, st
        return jax.lax.fori_loop(
            0, k_chain, body, (jnp.float32(0.0), iq_re, states))

    t0 = time.time()
    jax.block_until_ready(chained(iq.re, iq.im, states))
    log(f"chained-step compile+first run: {time.time()-t0:.1f}s")
    m, stc = 3, states
    t0 = time.time()
    for _ in range(m):
        acc, _, stc = chained(iq.re, iq.im, stc)
    jax.block_until_ready((acc, stc))
    dt_chain = (time.time() - t0) / (m * k_chain)
    msps_chain = samples / dt_chain / 1e6
    hits_chain = int(np.asarray(stc.counters)[:, 3].sum())
    log(f"steady-state ({m}x{k_chain} chained steps, one dispatch "
        f"per {k_chain}, hoist-proof): {dt_chain*1000:.2f} ms/step "
        f"-> {msps_chain:.0f} MS/s/card sustained "
        f"(cumulative hits={hits_chain})")
    msps = max(msps, msps_chain)

    for extra in (bench_fec, bench_ingest, bench_192k, bench_dofft,
                  bench_demod, bench_live_soak):
        extra(log)

    print(json.dumps({
        "metric": "IQ Msamples/s/card through FFT+FIR+BPSK chain",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / 0.192, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
