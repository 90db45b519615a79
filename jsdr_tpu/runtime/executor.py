"""Streaming executor — the framework's main loop (the analog of the
reference's capture thread + handler fan-out, JavaAudio.java:195-329).

Composes: source -> host conversion -> block framing -> device pipeline
(spectrum and/or demod chains) -> taps (pub/sub observability) -> sinks,
with per-stage wall/sample timers and optional periodic state
checkpointing. All carried DSP state lives in explicit pytrees, so a
session can be stopped and resumed exactly.

Double-buffered dispatch: while the device crunches block N, the host
converts/frames block N+1 (jax's async dispatch gives this for free —
we simply avoid blocking on results until the next block is submitted).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import numpy as np

from .log import Logger, StageTimers
from .pubsub import PubSub
from .state import load_state, save_state


@dataclass
class Session:
    """One streaming processing session.

    Sources may yield either complex64 chunks (host-converted, the
    legacy path) or interleaved int16 chunks (raw mode): raw chunks are
    published verbatim on the 'raw-block' topic BEFORE conversion (the
    IRawHandler fan-out, JavaAudio.java:261-265) and then converted ON
    DEVICE (io.convert_device.s16_to_cf — int16 upload halves transfer
    bytes and the wrap/scale loop runs on the device), with ``i_corr`` /
    ``q_corr`` applied there (JavaAudio.java:275-293 semantics).
    """

    source: Iterator[np.ndarray]          # complex64 or int16 chunks
    block_samples: int
    pubsub: PubSub = field(default_factory=PubSub)
    logger: Logger = field(default_factory=Logger)
    timers: StageTimers = field(default_factory=StageTimers)
    checkpoint_path: Optional[Path] = None
    checkpoint_every_blocks: int = 0
    checkpoint_meta: dict = field(default_factory=dict)  # stamped + checked
    dropped_blocks: dict = field(default_factory=dict)  # stage name -> count
    i_corr: int = 0                      # DC corrections for raw-mode
    q_corr: int = 0                      # device conversion
    channels: int = 2

    def run(self, stages: list["Stage"], max_blocks: Optional[int] = None):
        """Drive blocks through the stages until the source ends."""
        import jax
        import jax.numpy as jnp
        from ..io.framer import BlockFramer, RawBlockFramer

        framer = None
        n = 0
        for chunk in self.source:
            if framer is None:
                raw = np.asarray(chunk).dtype == np.int16
                framer = (RawBlockFramer(self.block_samples, self.channels)
                          if raw else BlockFramer(self.block_samples))
            for block in framer.push(chunk):
                with self.timers.stage("h2d", samples=self.block_samples):
                    if raw:
                        # raw fan-out precedes conversion — recorder taps
                        # see the exact capture bytes (recorder.java:66-74)
                        self.pubsub.publish("raw-block", block)
                        from ..io.convert_device import s16_to_cf
                        dev = s16_to_cf(jnp.asarray(block),
                                        jnp.int32(self.i_corr),
                                        jnp.int32(self.q_corr),
                                        channels=self.channels)
                    else:
                        from ..ops.cplx import as_cf
                        dev = as_cf(block)  # host split; upload at jit
                for stage in stages:
                    with self.timers.stage(stage.name, samples=len(block)):
                        # snapshot carried state so a retry re-runs the block
                        # against the SAME state the failed attempt saw (the
                        # first attempt may have advanced state before dying
                        # in e.g. a publish callback)
                        state0 = stage.state
                        try:
                            stage.process(dev, self)
                        except Exception as e:  # noqa: BLE001
                            # a live stream must keep going: retry once,
                            # then skip the block for this stage, count it
                            # in dropped_blocks and publish 'dropped-block'
                            self.logger.alert(
                                f"stage {stage.name} failed: {e!r:.120}; retrying")
                            stage.state = state0
                            try:
                                stage.process(dev, self)
                            except Exception as e2:  # noqa: BLE001
                                stage.state = state0
                                self.dropped_blocks[stage.name] = (
                                    self.dropped_blocks.get(stage.name, 0) + 1)
                                self.logger.alert(
                                    f"stage {stage.name} failed twice; "
                                    f"dropping block {n} "
                                    f"(total dropped: "
                                    f"{self.dropped_blocks[stage.name]}): "
                                    f"{e2!r:.120}")
                                self.pubsub.publish(
                                    "dropped-block",
                                    {"stage": stage.name, "block": n,
                                     "total": self.dropped_blocks[stage.name]})
                self.pubsub.publish("audio-frame", n)
                n += 1
                if (self.checkpoint_path and self.checkpoint_every_blocks
                        and n % self.checkpoint_every_blocks == 0):
                    self.save_checkpoint(stages)
                if max_blocks is not None and n >= max_blocks:
                    self._finish(stages)
                    return n
        self._finish(stages)
        return n

    def _finish(self, stages: list["Stage"]):
        """Flush stages that defer device readbacks (e.g. telemetry
        batches counter/frame syncs every N blocks)."""
        for stage in stages:
            try:
                stage.finish(self)
            except Exception as e:  # noqa: BLE001
                self.logger.alert(f"stage {stage.name} finish: {e!r:.120}")

    def save_checkpoint(self, stages: list["Stage"]):
        state = {s.name: s.state for s in stages if s.state is not None}
        if state and self.checkpoint_path:
            save_state(self.checkpoint_path, state, meta=self.checkpoint_meta)
            self.logger.log(f"checkpoint -> {self.checkpoint_path}")

    def load_checkpoint(self, stages: list["Stage"]):
        if self.checkpoint_path and Path(self.checkpoint_path).exists():
            like = {s.name: s.state for s in stages if s.state is not None}
            loaded = load_state(self.checkpoint_path, like,
                                expect_meta=self.checkpoint_meta)
            for s in stages:
                if s.state is not None and s.name in loaded:
                    s.state = loaded[s.name]
            self.logger.status(f"resumed from {self.checkpoint_path}")


class Stage:
    """A pipeline stage with carried device state (subclass or wrap)."""

    name = "stage"
    state: Any = None

    def process(self, block, session: Session):
        raise NotImplementedError

    def finish(self, session: Session):
        """Flush deferred work at stream end (optional)."""


class SpectrumStage(Stage):
    """fft.java analog: PSD per sub-block, published as 'fft-psd'.

    With ``waterfall_width`` set (must divide fft_n), the stage also
    publishes ready-to-render 8-bit waterfall lines ('waterfall-line'
    topic), max-decimated to that width on the device.
    """

    name = "spectrum"

    def __init__(self, rate: int, fft_n: Optional[int] = None,
                 window: bool = True, waterfall_width: Optional[int] = None):
        self.rate = rate
        self.fft_n = fft_n or rate // 10
        self.window = window
        self.waterfall_width = waterfall_width

    def process(self, block, session: Session):
        from ..ops.spectrum import spectrum_block
        n = (block.shape[-1] // self.fft_n) * self.fft_n
        blocks = block[:n].reshape(-1, self.fft_n)
        if self.waterfall_width:
            from ..ops.mxu_fft import fft_cf
            from ..ops.spectrum import psd_waterfall
            from ..ops.windows import hamming
            x = blocks * hamming(self.fft_n) if self.window else blocks
            spec = fft_cf(x)
            db, lines = psd_waterfall(spec, width=self.waterfall_width)
            session.pubsub.publish("waterfall-line", np.asarray(lines))
            session.pubsub.publish("fft-psd", np.asarray(db))
        else:
            res = spectrum_block(blocks, rate=float(self.rate),
                                 window=self.window)
            session.pubsub.publish("fft-psd", np.asarray(res.psd))
            session.pubsub.publish(
                "fft-peak",
                (int(res.peak_freq[-1]), float(res.peak_db[-1])))


class TelemetryStage(Stage):
    """FUNcubeBPSKDemod + FECDecoder analog; publishes decoded frames.

    ``tunings``: optional list of per-instance NCO Hz — N demod tabs on
    the same stream in one batched call (jsdr.java:479-484).
    ``dofft`` / ``track_high``: optional per-instance bool lists (the
    FUNcube<n>-bpsk-dofft / -upper keys, FUNcubeBPSKDemod.java:97-99);
    a mixed set still runs as ONE batched call.

    ``sync_every``: device results are read back (counters published,
    frames decoded) only every N blocks — per-block ``np.asarray`` on
    device values is a host<->device sync that serializes dispatch and
    defeats the async overlap of host convert with device compute.
    Frames arrive at worst N blocks late (they are ~4.33 s apart); a
    final ``finish()`` flush drains the tail.

    ``mesh``: an optional ("dp", "sp") ``jax.sharding.Mesh`` — the
    production integration point for the multi-chip path (the analog of
    the reference shell wiring its N demod tabs into the running
    system, jsdr.java:475-502). With a mesh, every block runs through
    ``parallel.sharded.sharded_telemetry_step`` (dp shards the demod
    instances, sp shards the time axis with halo exchange); results and
    chained state are bit-identical to the single-device batched call.
    The instance list is padded up to a multiple of dp (replicating the
    last instance; padding is dropped from published results), and the
    session's ``block_samples`` must come from
    :meth:`block_samples_for` so each sp shard holds whole bit groups
    (and whole 0.1 s FFT blocks when any instance uses dofft).
    """

    name = "telemetry"

    def __init__(self, cfg, tunings=None, dofft=None, track_high=None,
                 sync_every: int = 4, mesh=None, max_hits: int = 4):
        from ..demod.bpsk import bpsk_init_batch
        self.cfg = cfg
        self.tunings = (None if tunings is None
                        else [float(t) for t in tunings])
        self.n = 1 if tunings is None else len(self.tunings)
        self.n_real = self.n            # instances the user asked for
        self.dofft = None if dofft is None else [bool(v) for v in dofft]
        self.track_high = (None if track_high is None
                           else [bool(v) for v in track_high])
        self.sync_every = max(1, int(sync_every))
        self.mesh = mesh
        self._pending = []              # un-synced device block outputs
        self._n_blocks = 0
        if mesh is None:
            self.state = bpsk_init_batch(cfg, self.n)
            return
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.sharded import sharded_telemetry_step
        dp = mesh.shape["dp"]
        pad = (-self.n) % dp
        if pad:                          # dp wants S % dp == 0
            self.tunings = ((self.tunings or [cfg.tuning])
                            + [self.tunings[-1] if self.tunings
                               else cfg.tuning] * pad)
            if self.dofft is not None:
                self.dofft = self.dofft + [self.dofft[-1]] * pad
            if self.track_high is not None:
                self.track_high = self.track_high + [self.track_high[-1]] * pad
            self.n += pad
        self._sharded = sharded_telemetry_step(mesh, rate=cfg.rate,
                                               max_hits=max_hits)
        self._iq_sharding = NamedSharding(mesh, P("dp", "sp"))
        self.state = jax.device_put(bpsk_init_batch(cfg, self.n),
                                    NamedSharding(mesh, P("dp")))

    @staticmethod
    def block_samples_for(cfg, mesh=None, dofft=None,
                          target_seconds: float = 1.0) -> int:
        """Session block size valid for this stage's execution path."""
        if mesh is None:
            return int(cfg.rate * target_seconds)
        from ..parallel.sharded import valid_block_samples
        any_dofft = bool(np.any(dofft)) if dofft is not None else False
        return valid_block_samples(cfg.rate, mesh.shape["sp"], any_dofft,
                                   target_seconds)

    def process(self, block, session: Session):
        from ..demod.bpsk import bpsk_block_batch
        from ..ops.cplx import CF
        blocks = CF(jnp_broadcast(block.re, self.n),
                    jnp_broadcast(block.im, self.n))
        if self.mesh is not None:
            import jax
            blocks = CF(jax.device_put(blocks.re, self._iq_sharding),
                        jax.device_put(blocks.im, self._iq_sharding))
            out, self.state = self._sharded(
                blocks, self.state, self.tunings, dofft=self.dofft,
                track_high=self.track_high)
        else:
            out, self.state = bpsk_block_batch(
                blocks, self.cfg, self.state, self.tunings,
                dofft=self.dofft, track_high=self.track_high)
        self._pending.append(out)
        self._n_blocks += 1
        if self._n_blocks % self.sync_every == 0:
            self._drain(session)

    def finish(self, session: Session):
        self._drain(session)

    def _drain(self, session: Session):
        import numpy as np
        from ..fec.decoder import fec_decode
        pending, self._pending = self._pending, []
        if not pending:
            return
        tunings = self.tunings or [self.cfg.tuning]
        # live raw/ds/bit/sync counters, the reference's on-screen
        # instrumentation (FUNcubeBPSKDemod.java:219-228)
        c = np.asarray(self.state.counters)
        session.pubsub.publish(
            "telemetry-counters",
            {s: tuple(int(v) for v in c[s]) for s in range(self.n_real)})
        for s in range(self.n_real):
            session.pubsub.publish(f"FUNcube{s}-bpsk-tune", tunings[s])
        for out in pending:
            hits = np.asarray(out.n_hits)
            for s in range(self.n_real):
                n_hits = int(hits[s])
                if not n_hits:
                    continue
                res = fec_decode(out.windows[s, :n_hits])
                for i in range(n_hits):
                    frame = {
                        "demod": s,
                        "tuning": tunings[s],
                        "ok": bool(res.ok[i]),
                        "corr": int(out.hit_corr[s, i]),
                        "channel_errors": int(res.rc[i]),
                        "payload": np.asarray(res.payload[i]),
                    }
                    session.pubsub.publish("telemetry-frame", frame)


class SpectrumTelemetryStage(TelemetryStage):
    """Spectrum + telemetry of every block in one stage
    (demod.bpsk.bpsk_block_batch_spectrum): the fft.java +
    FUNcubeBPSKDemod.java pair of every reference block. Publishes
    'waterfall-line' (dB max-decimated lines) and 'fft-peak' alongside
    the telemetry topics."""

    name = "spectrum-telemetry"

    def __init__(self, cfg, tunings=None, window: bool = True,
                 sync_every: int = 4, mesh=None):
        if mesh is not None:
            raise ValueError(
                "SpectrumTelemetryStage runs on one device; for a device "
                "mesh use TelemetryStage(mesh=...) plus a SpectrumStage")
        super().__init__(cfg, tunings, sync_every=sync_every)
        self.window = window

    def process(self, block, session: Session):
        from ..demod.bpsk import bpsk_block_batch_spectrum
        from ..ops.cplx import CF
        blocks = CF(jnp_broadcast(block.re, self.n),
                    jnp_broadcast(block.im, self.n))
        spec, out, self.state = bpsk_block_batch_spectrum(
            blocks, self.cfg, self.state, self.tunings, window=self.window)
        self._pending.append(out)
        self._spec = spec
        self._n_blocks += 1
        if self._n_blocks % self.sync_every == 0:
            self._drain(session)

    def _drain(self, session: Session):
        spec = getattr(self, "_spec", None)
        if spec is not None:
            self._spec = None
            # stream 0's lines/peak (instances share the input stream)
            lines = np.asarray(spec.wf[0])
            session.pubsub.publish("waterfall-line", lines)
            session.pubsub.publish(
                "fft-peak", (int(np.asarray(spec.peak_freq)[0, -1]),
                             float(np.asarray(spec.peak_db)[0, -1])))
        super()._drain(session)


def jnp_broadcast(x, n: int):
    import jax.numpy as jnp
    return jnp.broadcast_to(x, (n, *x.shape))


class DemodStage(Stage):
    """demod.java analog; publishes float audio blocks."""

    name = "demod"

    def __init__(self, cfg):
        from ..demod.am_fm import AmFmState
        self.cfg = cfg
        self.state = AmFmState.init(cfg)

    def process(self, block, session: Session):
        import numpy as np
        from ..demod.am_fm import demod_block
        audio, mx, avg, self.state = demod_block(block, self.cfg, self.state)
        session.pubsub.publish("audio-out", np.asarray(audio))


class AudioSinkStage(Stage):
    """Real-time audio output stage: subscribes to the demod stage's
    'audio-out' blocks and feeds them to a live sink (demod.java:489-506
    analog — the writer thread lives in :class:`~jsdr_tpu.io.live.AudioSink`).

    Place it AFTER the DemodStage in the stage list; it consumes the
    block published during this executor iteration.
    """

    name = "audio-sink"

    def __init__(self, sink):
        self.sink = sink                 # an io.live.AudioSink
        self._last = None

    def process(self, block, session: Session):
        audio = session.pubsub.get("audio-out")
        # identity check: if the demod stage dropped this block, don't
        # replay the previous block's audio
        if audio is not None and audio is not self._last:
            self.sink.write(audio)
            self._last = audio

    def close(self):
        self.sink.close()


class RecorderStage(Stage):
    """recorder.java analog: append capture data to a raw S16LE file
    while enabled; produces replayable fixtures.

    In a raw-mode session (int16 source) the stage taps the
    'raw-block' topic — the PRE-conversion bytes, so the recorded file
    is byte-identical to the capture even with audio-ic/qc corrections
    set (recorder.java is an IRawHandler fed before the short->float
    convert, JavaAudio.java:261-265). In a complex-source session it
    falls back to re-encoding the converted block (lossy round-trip
    when corrections are nonzero)."""

    name = "recorder"

    def __init__(self, path, enabled: bool = True):
        from ..io.recorder import RawRecorder
        self.rec = RawRecorder(path).open()
        self.enabled = enabled
        self._last_raw = None

    def process(self, block, session: Session):
        if not self.enabled:
            return
        raw = session.pubsub.get("raw-block")
        if raw is not None and raw is not self._last_raw:
            self.rec.write_raw(np.asarray(raw).astype("<i2").tobytes())
            self._last_raw = raw
        elif raw is None:
            iq = (np.asarray(block.re) + 1j * np.asarray(block.im)
                  ).astype(np.complex64)
            self.rec.write_iq(iq)

    def close(self):
        self.rec.close()
