#!/usr/bin/env python3
"""Smoke test of the flagship path on one GPU, at the bench's full width.

Run from the repository root:

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the dp=2 x sp=2 sharded
                                   # telemetry step against one card

Phases (one card), each fails the run on any mismatch:

1. the device is a GPU (no CPU fallback); the card's name and power limit;
2. the display spectrum + FUNcube telemetry step at 96 kS/s, 128 streams
   x 4.8 s, two chained blocks, every synthesized frame decoded with
   AO-40 FEC to its payload; compile time, step time, memory;
3. the same at 192 kS/s, 256 streams x 2.4 s, three chained blocks;
4. the same jitted step on the CPU for the first 8 streams of phases 2
   and 3: identical frames, sync hits, soft windows and bit decisions,
   waterfall within 1e-3 dB, equal peak frequencies except at near-ties;
5. the CLI ``synth telemetry`` + ``telemetry`` commands in this process
   (16 manual instances, then 16 auto-tuned ones), and the streaming
   Session + TelemetryStage path with zero dropped blocks;
6. FEC decode at batch 256 with 120 channel errors per frame against the
   numpy oracle;
7. WFM demod (DemodStage) at 96 kS/s against the CPU;
8. the display SpectrumStage with 1920-pixel waterfall lines at
   96 kS/s against the CPU: PSD within 1e-5 of each line's peak power,
   waterfall pixels at most one intensity level apart.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "chiprun_out" / "chip_smoke"
N_KINDS = 8          # distinct synthesized downlinks, cycled over streams
CPU_STREAMS = 8      # streams re-run on the CPU for comparison
WF_TOL_DB = 1e-3     # waterfall GPU vs CPU, bins within 120 dB of the peak
# full-resolution PSD, GPU vs CPU, in linear power over the line's peak:
# an f32 FFT's rounding error is about 1e-6 of the peak power on either
# side (against a float64 FFT), which in dB grows without bound in the
# deep bins of the 9,600-bin lines
PSD_TOL_REL = 1e-5


def log(*a):
    print(*a, flush=True)


def card_info() -> str:
    """nvidia-smi's name and power limit, from a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def require_gpu(n_cards: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform is "
                         f"{devs[0].platform!r})")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found "
                         f"{len(devs)}")
    return devs


def import_repo():
    """The package next to this script, never an installed copy."""
    sys.path.insert(0, str(ROOT))
    import jsdr_tpu
    if Path(jsdr_tpu.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: jsdr_tpu imported from "
                         f"{jsdr_tpu.__file__}, not from {ROOT}")


def downlinks(rate: int, frames: int, length: int, seed: int):
    """N_KINDS synthesized FUNcube downlinks (as bench.py synthesizes its
    input: 400 preamble bits, noise 0.3), zero-padded to ``length``.
    Returns (iq [N_KINDS, length] complex64, payloads [N_KINDS, frames,
    256])."""
    from jsdr_tpu.io.sources import synth_bpsk_stream
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (N_KINDS, frames, 256), dtype=np.uint8)
    iq = np.zeros((N_KINDS, length), np.complex64)
    for k in range(N_KINDS):
        sig = synth_bpsk_stream(payloads[k], rate=rate, preamble_bits=400,
                                noise_rms=0.3, seed=seed + k)
        assert len(sig) <= length, (len(sig), length)
        iq[k, :len(sig)] = sig
    return iq, payloads


def decode_hits(outs, fec_batch: int = 128):
    """FEC-decode every sync hit of a list of per-block BpskBlockOut
    (host arrays), ``fec_batch`` windows per call (phase 6 compiles batch
    256 on its own, so its compile time is reported by itself). Returns
    {stream: [(payload, ok, rc), ...]} in order."""
    import jax.numpy as jnp
    from jsdr_tpu.fec.decoder import fec_decode
    keys, wins = [], []
    for out in outs:
        for s in range(out.n_hits.shape[0]):
            for i in range(int(out.n_hits[s])):
                keys.append(s)
                wins.append(out.windows[s, i])
    frames = {}
    for lo in range(0, len(wins), fec_batch):
        chunk = np.full((fec_batch, wins[0].shape[-1] if wins else 5200),
                        0x40, np.uint8)
        part = wins[lo:lo + fec_batch]
        chunk[:len(part)] = part
        res = fec_decode(jnp.asarray(chunk))
        pay, ok, rc = (np.asarray(res.payload), np.asarray(res.ok),
                       np.asarray(res.rc))
        for j in range(len(part)):
            frames.setdefault(keys[lo + j], []).append(
                (pay[j], bool(ok[j]), int(rc[j])))
    return frames


def check_frames(frames, kind, payloads, what: str):
    """Every stream decodes exactly its transmitted frames, all ok."""
    n_bad = 0
    for s in range(len(kind)):
        got = frames.get(s, [])
        want = payloads[kind[s]]
        ok = (len(got) == len(want)
              and all(f[1] and np.array_equal(f[0], p)
                      for f, p in zip(got, want)))
        n_bad += not ok
    total = sum(len(v) for v in frames.values())
    log(f"{what}: {total} sync hits decoded, {len(kind) * payloads.shape[1]}"
        f" frames transmitted, streams with a wrong or missing frame: "
        f"{n_bad}")
    assert n_bad == 0, f"{what}: {n_bad} streams did not decode every frame"


def run_flagship(rate: int, n_streams: int, t_len: int, n_blocks: int,
                 frames: int, seed: int):
    """Phases 2/3: the flagship step on the GPU over chained blocks."""
    import jax
    from jsdr_tpu.demod.bpsk import (BpskConfig, bpsk_block_batch_spectrum,
                                     bpsk_init_batch)
    from jsdr_tpu.ops.cplx import from_complex

    cfg = BpskConfig(rate=rate, tuning=12000.0)
    base, payloads = downlinks(rate, frames, n_blocks * t_len, seed)
    kind = np.arange(n_streams) % N_KINDS
    step = jax.jit(lambda iq, st: bpsk_block_batch_spectrum(iq, cfg, st))

    def block(b, streams):
        return from_complex(base[kind[:streams], b * t_len:(b + 1) * t_len])

    iq0 = jax.device_put(block(0, n_streams))
    st = jax.device_put(bpsk_init_batch(cfg, n_streams))
    t0 = time.time()
    compiled = step.lower(iq0, st).compile()
    t_compile = time.time() - t0
    tag = f"{rate // 1000} kS/s {n_streams}x{t_len / rate:g}s"
    log(f"{tag}: compile {t_compile:.2f} s; memory_analysis: "
        f"{compiled.memory_analysis()}")

    outs, specs = [], []
    for b in range(n_blocks):
        iq = iq0 if b == 0 else jax.device_put(block(b, n_streams))
        spec, out, st = compiled(iq, st)
        outs.append(jax.device_get(out))
        specs.append(jax.device_get(
            jax.tree.map(lambda x: x[:CPU_STREAMS], spec)))
    # steady step time: the last block again, state chained, one
    # dispatch per step, waited on with block_until_ready
    reps = 5
    jax.block_until_ready(compiled(iq, st))
    t0 = time.time()
    s2 = st
    for _ in range(reps):
        _, _, s2 = compiled(iq, s2)
    jax.block_until_ready(s2)
    dt = (time.time() - t0) / reps
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"{tag}: step {dt * 1e3:.3f} ms ({n_streams * t_len / dt / 1e6:.1f}"
        f" MS/s), peak_bytes_in_use {peak}")
    frames_dec = decode_hits(outs)
    check_frames(frames_dec, kind, payloads, tag)
    gpu = {"outs": outs, "specs": specs, "frames": frames_dec}
    return cfg, step, (lambda b: block(b, CPU_STREAMS)), gpu, tag


def compare_cpu(cfg, step, cpu_block, gpu, n_blocks: int, tag: str):
    """Phase 4: the same jitted step on the CPU for CPU_STREAMS streams."""
    import jax
    from jsdr_tpu.demod.bpsk import bpsk_init_batch

    cpu = jax.devices("cpu")[0]
    outs, specs = [], []
    with jax.default_device(cpu):
        st = jax.device_put(bpsk_init_batch(cfg, CPU_STREAMS), cpu)
        for b in range(n_blocks):
            spec, out, st = step(jax.device_put(cpu_block(b), cpu), st)
            outs.append(jax.device_get(out))
            specs.append(jax.device_get(spec))
        frames_cpu = decode_hits(outs)
    frames_gpu = {s: v for s, v in gpu["frames"].items() if s < CPU_STREAMS}
    same_frames = (frames_cpu.keys() == frames_gpu.keys() and all(
        len(frames_cpu[s]) == len(frames_gpu[s])
        and all(np.array_equal(a[0], b[0]) and a[1:] == b[1:]
                for a, b in zip(frames_cpu[s], frames_gpu[s]))
        for s in frames_cpu))
    hits_equal, bit_mismatch, n_compared, where = True, 0, 0, []
    n_win_diff = 0
    for b, (og, oc) in enumerate(zip(gpu["outs"], outs)):
        hits_equal &= np.array_equal(og.n_hits[:CPU_STREAMS], oc.n_hits)
        for s in range(CPU_STREAMS):
            h = int(oc.n_hits[s])
            win_same = np.array_equal(og.windows[s, :h], oc.windows[s, :h])
            if not win_same:
                n_win_diff += 1
            ng, nc = int(og.n_bits[s]), int(oc.n_bits[s])
            n = min(ng, nc)
            diff = np.nonzero(og.bits[s, :n] != oc.bits[s, :n])[0]
            bit_mismatch += abs(ng - nc) + len(diff)
            n_compared += max(ng, nc)
            if ng != nc or len(diff):
                where.append((b, s, ng, nc, diff[:4].tolist()))
    wf_err, freq_diff, near_ties = 0.0, 0, []
    for sg, sc in zip(gpu["specs"], specs):
        live = sc.wf >= sc.peak_db[..., None] - 120.0
        wf_err = max(wf_err, float(np.max(np.abs(sg.wf - sc.wf)[live])))
        for s, k in zip(*np.nonzero(sg.peak_freq != sc.peak_freq)):
            freq_diff += 1
            # a near-tie when the two peaks' dB values agree within the
            # tolerance (the two top bins compete)
            if abs(float(sg.peak_db[s, k] - sc.peak_db[s, k])) <= WF_TOL_DB:
                near_ties.append((int(s), int(k), int(sg.peak_freq[s, k]),
                                  int(sc.peak_freq[s, k])))
    log(f"{tag} GPU vs CPU ({CPU_STREAMS} streams, full length): frames "
        f"identical={same_frames}, n_hits identical={hits_equal}, soft "
        f"windows of sync hits that differ={n_win_diff}, bit decision "
        f"mismatches={bit_mismatch} "
        f"of {n_compared} (block, stream, n_bits GPU, n_bits CPU, first "
        f"differing indices: {where}), max |waterfall dB diff| (bins "
        f"within 120 dB of peak)={wf_err:.3g}, peak_freq "
        f"differences={freq_diff} (near-ties: {near_ties})")
    assert same_frames and hits_equal, f"{tag}: CPU and GPU frames differ"
    assert bit_mismatch == 0, f"{tag}: {bit_mismatch} bit mismatches"
    assert wf_err <= WF_TOL_DB, f"{tag}: waterfall differs by {wf_err} dB"
    assert freq_diff == len(near_ties), f"{tag}: peak frequencies differ"


def parse_cli_frames(text: str):
    """(demod index, payload bytes) of each frame the CLI printed."""
    frames, cur = [], None
    for line in text.splitlines():
        m = re.match(r"(?:demod(\d+)@\S+ )?t=\d+s corr=\d+ channel_errors",
                     line)
        if m:
            cur = [int(m.group(1) or 0), []]
            frames.append(cur)
            continue
        m = re.match(r"\s+(\d+): ((?:[0-9a-f]{2} ?)+)$", line)
        if m and cur is not None:
            cur[1] += [int(v, 16) for v in m.group(2).split()]
    return [(d, np.asarray(p, np.uint8)) for d, p in frames]


def run_cli():
    """Phase 5: the CLI commands in this process, then the streaming
    Session + TelemetryStage as ``telemetry --pace/--loop`` builds it."""
    from jsdr_tpu.app.main import main as cli
    from jsdr_tpu.demod.bpsk import BpskConfig
    from jsdr_tpu.io.sources import FileSource
    from jsdr_tpu.runtime.executor import Session, TelemetryStage

    n_inst, secs, rate = 16, 18, 96000
    WORK.mkdir(parents=True, exist_ok=True)
    raw = str(WORK / "telemetry.raw")
    with contextlib.redirect_stdout(io.StringIO()):
        cli(["--rate", str(rate), "--seconds", str(secs), "synth",
             "telemetry", "--noise", "0.1", "--out", raw])
    payloads = np.load(raw + ".payloads.npy")
    n_frames = len(payloads)

    def check(text, what):
        got = sorted(parse_cli_frames(text), key=lambda f: f[0])
        want = [(d, p) for d in range(n_inst) for p in payloads]
        ok = (len(got) == len(want) and all(
            g[0] == w[0] and np.array_equal(g[1], w[1])
            for g, w in zip(got, want)))
        summary = re.findall(r"frames=\d+", text)
        log(f"CLI telemetry ({what}, {n_inst} instances): {len(got)}/"
            f"{len(want)} frames printed with the sent payloads ({summary})")
        assert ok, f"CLI telemetry ({what}) lost or corrupted frames"

    for what, extra in (("manual", ["--tuning", ",".join(["12000"] * n_inst)]),
                        ("auto-tuned", ["--fft-tune", "--tuning",
                                        ",".join(["0"] * n_inst)])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["--rate", str(rate), "--seconds", str(secs), "telemetry",
                 f"file:{raw}"] + extra)
        check(buf.getvalue(), what)

    # the streaming path (cmd_telemetry_stream): 15 manual instances and
    # one auto-tuned, looped file source, 1 s blocks
    tunings = [12000.0] * (n_inst - 1) + [0.0]
    dofft = [False] * (n_inst - 1) + [True]
    cfg = BpskConfig(rate=rate, tuning=tunings[0])
    stage = TelemetryStage(cfg, tunings, dofft=dofft,
                           track_high=[False] * n_inst)
    fsrc = FileSource(raw, rate=rate, channels=2, loop=True)
    session = Session(source=fsrc.blocks(rate // 10),
                      block_samples=TelemetryStage.block_samples_for(
                          cfg, None, dofft))
    frames = []
    session.pubsub.listen(lambda t, v: frames.append(v)
                          if t == "telemetry-frame" else None)
    n = session.run([stage], max_blocks=secs)
    seen = [0] * n_inst                 # frames so far per instance
    good = 0
    for f in frames:
        k = seen[f["demod"]]
        seen[f["demod"]] += 1
        good += bool(f["ok"] and k < n_frames
                     and np.array_equal(f["payload"], payloads[k]))
    log(f"Session + TelemetryStage: {n} blocks, {good}/{n_inst * n_frames} "
        f"frames published with the sent payloads, dropped blocks: "
        f"{session.dropped_blocks or 0}")
    assert not session.dropped_blocks, session.dropped_blocks
    assert good == len(frames) == n_inst * n_frames


def run_fec():
    """Phase 6: batched FEC decode against the numpy oracle."""
    import jax
    import jax.numpy as jnp
    from jsdr_tpu.fec import ref_numpy
    from jsdr_tpu.fec.decoder import fec_decode

    batch = 256
    rng = np.random.default_rng(1)
    payloads = rng.integers(0, 256, (batch, 256), dtype=np.uint8)
    raws = np.stack([ref_numpy.symbols_to_soft(ref_numpy.encode_fec40(p))
                     for p in payloads])
    for r in raws:                      # as bench.py: 120 channel errors
        r[rng.choice(5200, 120, replace=False)] ^= 0x80
    x = jax.device_put(jnp.asarray(raws))
    t0 = time.time()
    compiled = fec_decode.lower(x).compile()
    t_compile = time.time() - t0
    res = jax.block_until_ready(compiled(x))
    t0 = time.time()
    reps = 5
    for _ in range(reps):
        res = compiled(x)
    jax.block_until_ready(res)
    dt = (time.time() - t0) / reps
    oracle = [ref_numpy.fec_decode(r) for r in raws]
    ok = bool(np.all(np.asarray(res.ok)))
    same = all(np.array_equal(np.asarray(res.payload[i]), o[0])
               and int(res.rc[i]) == o[1] for i, o in enumerate(oracle))
    log(f"FEC batch {batch}, 120 channel errors/frame: all ok={ok}, "
        f"payloads and rc equal to the numpy oracle={same}, "
        f"{dt * 1e3:.3f} ms/batch ({batch / dt:.0f} frames/s); compile "
        f"{t_compile:.2f} s (a load when the persistent cache holds it)")
    assert ok and same


def stage_outputs(stage, sig, rate: int, device, topics):
    """Drive one Session stage over ``sig`` in 1 s blocks on ``device``;
    returns {topic: [published values]}. A dropped block fails."""
    import jax
    from jsdr_tpu.runtime.executor import Session
    got = {tp: [] for tp in topics}
    with jax.default_device(device):
        sess = Session(source=iter([sig]), block_samples=rate)
        sess.pubsub.listen(lambda tp, v: got[tp].append(np.asarray(v))
                           if tp in got else None)
        sess.run([stage])
        assert not sess.dropped_blocks, sess.dropped_blocks
    return got


def fm_test_signal(rate: int, secs: int):
    """A 1 kHz tone, 15 kHz deviation, on a carrier 5 kHz off centre,
    in complex noise."""
    t = np.arange(secs * rate) / rate
    phase = 2 * np.pi * 5000 * t + 15.0 * np.sin(2 * np.pi * 1000 * t)
    rng = np.random.default_rng(5)
    return (0.5 * np.exp(1j * phase) + 0.05 * (
        rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t)))
            ).astype(np.complex64)


def run_wfm():
    """Phase 7: WFM DemodStage at 96 kS/s, GPU vs CPU."""
    import jax
    from jsdr_tpu.demod.am_fm import AmFmConfig, Mode
    from jsdr_tpu.runtime.executor import DemodStage

    rate, secs = 96000, 3
    sig = fm_test_signal(rate, secs)
    cfg = AmFmConfig(rate=rate, mode=int(Mode.WFM), dofir=True, dodwn=True,
                     doagc=True, flo=-20000, fhi=20000)
    gpu, cpu = (np.concatenate(stage_outputs(
        DemodStage(cfg), sig, rate, d, ["audio-out"])["audio-out"])
        for d in (jax.devices()[0], jax.devices("cpu")[0]))
    err = float(np.max(np.abs(gpu - cpu)))
    log(f"WFM DemodStage {secs}x1 s blocks at {rate} S/s: max |GPU - CPU| "
        f"audio = {err:.3g} (tolerance 1e-4 on AGC-normalised audio)")
    assert gpu.shape == cpu.shape and np.all(np.isfinite(gpu))
    assert err <= 1e-4


def run_spectrum_stage():
    """Phase 8: SpectrumStage with 1920-pixel waterfall lines at
    96 kS/s, GPU vs CPU."""
    import jax
    from jsdr_tpu.runtime.executor import SpectrumStage

    rate, secs, width = 96000, 3, 1920
    sig = fm_test_signal(rate, secs)
    topics = ["fft-psd", "waterfall-line"]
    gpu, cpu = ({tp: np.concatenate(v) for tp, v in stage_outputs(
        SpectrumStage(rate, waterfall_width=width), sig, rate, d,
        topics).items()} for d in (jax.devices()[0], jax.devices("cpu")[0]))
    db_g, db_c = gpu["fft-psd"], cpu["fft-psd"]
    p_g, p_c = 10.0 ** (db_g / 10), 10.0 ** (db_c / 10)
    p_err = float(np.max(np.abs(p_g - p_c) / p_c.max(axis=-1, keepdims=True)))
    line_diff = np.abs(gpu["waterfall-line"].astype(int)
                       - cpu["waterfall-line"].astype(int))
    log(f"SpectrumStage waterfall_width={width}, {secs}x1 s blocks at "
        f"{rate} S/s: lines {gpu['waterfall-line'].shape}, max |PSD GPU - "
        f"CPU| = {p_err:.3g} of the line's peak power (tolerance "
        f"{PSD_TOL_REL:g}), max |dB diff| = "
        f"{float(np.max(np.abs(db_g - db_c))):.3g}, pixels one intensity "
        f"level apart: {int(np.sum(line_diff == 1))}, more: "
        f"{int(np.sum(line_diff > 1))}")
    assert gpu["waterfall-line"].shape == (secs * 10, width)
    assert db_g.shape == db_c.shape and np.all(np.isfinite(db_g))
    assert p_err <= PSD_TOL_REL
    # intensity = trunc(255 + 2.55 dB): a dB difference within the
    # tolerance moves a pixel across at most one level boundary
    assert int(line_diff.max()) <= 1


def run_four(n_streams: int = 128, t_len: int = 460800):
    """--four: the dp=2 x sp=2 sharded telemetry step over four cards
    against the single-card chain on the same input."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jsdr_tpu.demod.bpsk import BpskConfig, bpsk_block_batch, \
        bpsk_init_batch
    from jsdr_tpu.ops.cplx import from_complex
    from jsdr_tpu.parallel import make_mesh, sharded_telemetry_step

    rate, n_blocks = 96000, 2
    mesh = make_mesh(dp=2, sp=2, devices=jax.devices()[:4])
    cfg = BpskConfig(rate=rate, tuning=12000.0)
    base, payloads = downlinks(rate, 2, n_blocks * t_len, seed=11)
    kind = np.arange(n_streams) % N_KINDS
    step = sharded_telemetry_step(mesh, rate=rate, max_hits=4)
    iq_sh = NamedSharding(mesh, P("dp", "sp"))
    st_m = jax.device_put(bpsk_init_batch(cfg, n_streams),
                          NamedSharding(mesh, P("dp")))
    st_1 = jax.device_put(bpsk_init_batch(cfg, n_streams), jax.devices()[0])
    outs_m, outs_1, mism = [], [], 0
    for b in range(n_blocks):
        blk = from_complex(base[kind, b * t_len:(b + 1) * t_len])
        o_m, st_m = step(jax.device_put(blk, iq_sh), st_m)
        o_1, st_1 = bpsk_block_batch(jax.device_put(blk, jax.devices()[0]),
                                     cfg, st_1)
        o_m, o_1 = jax.device_get(o_m), jax.device_get(o_1)
        for f in ("n_bits", "bits", "n_hits", "windows"):
            mism += int(not np.array_equal(getattr(o_m, f), getattr(o_1, f)))
        outs_m.append(o_m)
        outs_1.append(o_1)
    fr_m, fr_1 = decode_hits(outs_m), decode_hits(outs_1)
    same = fr_m.keys() == fr_1.keys() and all(
        len(fr_m[s]) == len(fr_1[s]) and all(
            np.array_equal(a[0], c[0]) and a[1:] == c[1:]
            for a, c in zip(fr_m[s], fr_1[s])) for s in fr_m)
    check_frames(fr_m, kind, payloads, "4-card dp=2 x sp=2")
    blk = jax.device_put(from_complex(base[kind, :t_len]), iq_sh)
    jax.block_until_ready(step(blk, st_m))
    reps = 5
    t0 = time.time()
    s2 = st_m
    for _ in range(reps):
        _, s2 = step(blk, s2)
    jax.block_until_ready(s2)
    dt = (time.time() - t0) / reps
    log(f"4-card dp=2 x sp=2 vs 1 card, {n_streams}x{t_len / rate:g}s x "
        f"{n_blocks} chained blocks: bits/n_bits/n_hits/windows fields "
        f"differing={mism}, frames identical={same}; sharded step "
        f"{dt * 1e3:.3f} ms ({n_streams * t_len / dt / 1e6:.1f} MS/s)")
    assert mism == 0 and same


def main(argv) -> int:
    four = "--four" in argv
    devs = require_gpu(4 if four else 1)
    import_repo()
    import jax
    from jsdr_tpu.runtime.device import init_compile_cache
    log(card_info())                    # the card's name, power limit
    log(f"JAX {jax.__version__}: {len(devs)} x {devs[0].device_kind}; "
        f"compilation cache {init_compile_cache()}")
    t_start = time.time()
    if four:
        run_four()
    else:
        for rate, streams, blocks, frames, seed in (
                (96000, 128, 2, 2, 0), (192000, 256, 3, 1, 3)):
            cfg, step, cpu_block, gpu, tag = run_flagship(
                rate, streams, 460800, blocks, frames, seed)
            compare_cpu(cfg, step, cpu_block, gpu, blocks, tag)
        run_cli()
        run_fec()
        run_wfm()
        run_spectrum_stage()
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
