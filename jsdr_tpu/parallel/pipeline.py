"""Pipeline parallelism: telemetry chain stages on separate device groups,
composable with data parallelism over streams.

SURVEY §2.2's PP obligation — the device analog of the reference's
thread/stage structure (capture thread -> demod handlers -> FEC/output,
JavaAudio.java:195-329 / FUNcubeBPSKDemod.java:357-595 /
FECDecoder.java:703): assign pipeline STAGES to device groups and
overlap them across successive blocks.

Stages over a ("pp", "dp") mesh (pp = number of stages, dp shards the
independent streams within each stage):

- **stage 0 (front end)**: per-stream NCO mix + 27-tap decimating
  polyphase FIR — the full-rate, memory-bandwidth-bound part
  (FUNcubeBPSKDemod.java:382-492 work).
- **stage 1 (decode tail)**: VCO mix -> matched filter -> timing
  recovery -> sync search on the decimated stream — the scan-heavy,
  low-FLOP part (:505-595 work).
- **stage 2 (FEC, optional — 3-stage meshes)**: batched AO-40 decode of
  the extracted soft windows (FECDecoder.java:703-852 work), so frame
  decoding overlaps BOTH upstream stages.

Schedule (GPipe-style, microbatch = one time block): at tick t, stage s
processes the payload stage s-1 produced at tick t-1; activations hop
one ``ppermute`` between ticks. The SPMD body picks its stage with
``lax.switch`` on ``axis_index("pp")`` — each device executes only its
own branch at runtime, so the stages genuinely overlap in wall time and
meet at the permute. The decimated handoff is rate/9600-times smaller
than the input; the windows handoff is smaller still.

**Validity travels with the data.** Every payload carries a ``valid``
flag: the first (n_stages-1) ticks prime the pipe with invalid payloads,
and ``pipeline_flush`` drains in-flight blocks by feeding BUBBLES
(valid=False inputs) — a stage receiving an invalid payload passes it
through without advancing any state, so a pipeline can be drained
MID-STREAM and resumed exactly (the round-2 zero-block flush advanced
the front-end state and could only be used at stream end).

State is exact: the front-end state (NCO numerator, decimator tail)
advances on stage 0, the decode state (VCO, matched filter, timing,
5199-bit ring, counters) on stage 1 — bit-identical to the sequential
``bpsk_block_batch`` chain with (n_stages-1) blocks of latency
(tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..demod import bpsk as B
from ..fec.decoder import fec_decode
from ..ops.cplx import CF, as_cf


def make_pp_mesh(n_stages: int = 2, dp: int = 1, devices=None) -> Mesh:
    """An [n_stages, dp] ("pp", "dp") mesh (uses the first n_stages*dp
    devices)."""
    need = n_stages * dp
    devs = list(devices if devices is not None else jax.devices())[:need]
    assert len(devs) == need, f"pipeline mesh needs {need} devices"
    return Mesh(np.array(devs).reshape(n_stages, dp), ("pp", "dp"))


class PipeOut(NamedTuple):
    """Per-tick pipeline output (leaves lead with [n_mb, S])."""

    telem: B.BpskBlockOut
    fec_ok: jnp.ndarray       # [S, max_hits] bool (3-stage only)
    fec_rc: jnp.ndarray       # [S, max_hits] i32 (-1 where no frame)
    fec_payload: jnp.ndarray  # [S, max_hits, 256] u8
    valid: jnp.ndarray        # [] bool — False on prime/bubble ticks


def _zero_out(s: int, t_ds: int, max_hits: int) -> B.BpskBlockOut:
    max_bits = 2 * (t_ds // B.SAMPLES_PER_BIT) + 2
    return B.BpskBlockOut(
        windows=jnp.full((s, max_hits, B.FEC_BITS), 0x40, jnp.uint8),
        hit_corr=jnp.zeros((s, max_hits), jnp.int32),
        n_hits=jnp.zeros((s,), jnp.int32),
        bits=jnp.zeros((s, max_bits), jnp.int8),
        n_bits=jnp.zeros((s,), jnp.int32),
        energies=jnp.zeros((s, 2), jnp.float32),
    )


def _zero_pipeout(s: int, t_ds: int, max_hits: int) -> PipeOut:
    return PipeOut(
        telem=_zero_out(s, t_ds, max_hits),
        fec_ok=jnp.zeros((s, max_hits), bool),
        fec_rc=jnp.full((s, max_hits), -1, jnp.int32),
        fec_payload=jnp.zeros((s, max_hits, 256), jnp.uint8),
        valid=jnp.zeros((), bool),
    )


class _Payload(NamedTuple):
    """The union inter-stage activation (one ppermute per tick)."""

    valid: jnp.ndarray      # [] bool
    ds_re: jnp.ndarray      # [S, T//m] front->tail
    ds_im: jnp.ndarray
    tu: jnp.ndarray         # [S] tu_phase snapshot after the block
    tail_re: jnp.ndarray    # [S, ntaps-1]
    tail_im: jnp.ndarray
    telem: B.BpskBlockOut   # tail->fec (zeros on the first hop)


def _zero_payload(s: int, t_ds: int, max_hits: int) -> _Payload:
    n_tail = len(B.DS_FILTER) - 1
    return _Payload(
        valid=jnp.zeros((), bool),
        ds_re=jnp.zeros((s, t_ds), jnp.float32),
        ds_im=jnp.zeros((s, t_ds), jnp.float32),
        tu=jnp.zeros((s,), jnp.float32),
        tail_re=jnp.zeros((s, n_tail), jnp.float32),
        tail_im=jnp.zeros((s, n_tail), jnp.float32),
        telem=_zero_out(s, t_ds, max_hits),
    )


def pipelined_telemetry(mesh: Mesh, rate: int = 96000, max_hits: int = 4,
                        compat_scan: bool = False):
    """Build the pipelined telemetry step over ``mesh`` (("pp",) or
    ("pp", "dp"); pp size 2 = front/tail, 3 = front/tail/FEC).

    Returns ``fn(iq_blocks, carry, tunings, bubble=None) -> (out,
    new_carry)``: ``iq_blocks`` [n_mb, S, T] (CF or host complex) —
    n_mb microbatches of S streams; ``carry`` starts as
    ``pipeline_init``. ``out`` is a PipeOut stacked over the n_mb ticks;
    out[t] decodes input block t-(n_stages-1) (earlier ticks have
    valid=False and all-zero fields). ``bubble`` [n_mb] bool marks ticks
    whose input must NOT be consumed (used by ``pipeline_flush``).
    Per-stream tunings must be multiples of 0.1 Hz (the exact
    int-numerator NCO path).
    """
    n_stages = mesh.shape["pp"]
    assert n_stages in (2, 3), "pipeline supports 2 or 3 stages"
    has_dp = "dp" in mesh.axis_names
    m = rate // B.DOWN_SAMPLE_RATE

    def local(iq_re, iq_im, bubble, carry, tunings, dofft, track_high, *,
              mix_mode: str):
        k = lax.axis_index("pp")
        # shard_map delivers the pp-stacked carry as a leading length-1
        # axis per rank; strip it (re-added on return)
        buf0, st0 = carry
        buf = jax.tree.map(lambda x: x[0], buf0)
        st = jax.tree.map(lambda x: x[0], st0)
        n_mb, s, t_len = iq_re.shape
        t_ds = t_len // m

        def tick(c, x):
            buf, st = c            # buf: this rank's incoming payload
            xr, xi, bub = x

            def stage0(_):
                # the shared front-end dispatcher (manual pattern/general
                # mix, FFT auto-tune, or per-stream mixed — the same
                # paths as the single-chip batch, demod.bpsk)
                ds, tail, tu, ft = B._front_dispatch(
                    CF(xr, xi), st, tunings, dofft, track_high,
                    rate=rate, mix_mode=mix_mode, static_tunings=None)
                # a bubble must not advance the front-end state
                st2 = st._replace(
                    tu_phase=jnp.where(bub, st.tu_phase, tu),
                    ds_tail=CF(jnp.where(bub, st.ds_tail.re, tail.re),
                               jnp.where(bub, st.ds_tail.im, tail.im)),
                    fft_tuner=jax.tree.map(
                        lambda new, old: jnp.where(bub, old, new),
                        ft, st.fft_tuner))
                p = _zero_payload(s, t_ds, max_hits)._replace(
                    valid=~bub, ds_re=ds.re, ds_im=ds.im, tu=tu,
                    tail_re=tail.re, tail_im=tail.im)
                return p, st2, _zero_pipeout(s, t_ds, max_hits)

            def stage1(_):
                ds = CF(buf.ds_re, buf.ds_im)
                tu, tail = buf.tu, CF(buf.tail_re, buf.tail_im)
                post = partial(B._bpsk_post, t_len=t_len, max_hits=max_hits,
                               compat_scan=compat_scan)
                telem, st2 = jax.vmap(post)(ds, st, tu, tail, st.fft_tuner)
                # invalid payloads (prime/bubble) pass through untouched
                st2 = jax.tree.map(
                    lambda new, old: jnp.where(buf.valid, new, old), st2, st)
                telem = jax.tree.map(
                    lambda o, z: jnp.where(buf.valid, o, z), telem,
                    _zero_out(s, t_ds, max_hits))
                p = _zero_payload(s, t_ds, max_hits)._replace(
                    valid=buf.valid, telem=telem)
                out = _zero_pipeout(s, t_ds, max_hits)._replace(
                    telem=telem, valid=buf.valid)
                return p, st2, out

            def stage2(_):
                telem = buf.telem
                res = fec_decode(telem.windows.reshape(-1, B.FEC_BITS))
                j = jnp.arange(max_hits)[None, :]
                live = (j < telem.n_hits[:, None]) & buf.valid
                ok = res.ok.reshape(s, max_hits) & live
                rc = jnp.where(live, res.rc.reshape(s, max_hits), -1)
                pay = jnp.where(live[:, :, None],
                                res.payload.reshape(s, max_hits, 256), 0)
                out = PipeOut(telem=telem, fec_ok=ok, fec_rc=rc,
                              fec_payload=pay.astype(jnp.uint8),
                              valid=buf.valid)
                return _zero_payload(s, t_ds, max_hits), st, out

            stages = [stage0, stage1, stage2][:n_stages]
            payload, st, out = lax.switch(jnp.minimum(k, n_stages - 1),
                                          stages, None)
            # activations hop stage s -> s+1
            hops = [(i, i + 1) for i in range(n_stages - 1)]
            nxt = jax.tree.map(lambda p: lax.ppermute(p, "pp", hops), payload)
            return (nxt, st), out

        (buf, st), outs = lax.scan(tick, (buf, st), (iq_re, iq_im, bubble))
        new_carry = (jax.tree.map(lambda x: x[None], buf),
                     jax.tree.map(lambda x: x[None], st))
        return new_carry, jax.tree.map(lambda x: x[None], outs)

    dp = "dp" if has_dp else None
    pp_dp = P("pp", dp)
    state_specs = jax.tree.map(lambda _: pp_dp,
                               B.bpsk_init(B.BpskConfig()))
    payload_specs = _Payload(
        valid=P("pp"), ds_re=pp_dp, ds_im=pp_dp, tu=pp_dp,
        tail_re=pp_dp, tail_im=pp_dp,
        telem=jax.tree.map(
            lambda _: pp_dp,
            B.BpskBlockOut(*([0] * len(B.BpskBlockOut._fields)))))
    carry_specs = (payload_specs, state_specs)
    out_specs = PipeOut(
        telem=jax.tree.map(
            lambda _: P("pp", None, dp),
            B.BpskBlockOut(*([0] * len(B.BpskBlockOut._fields)))),
        fec_ok=P("pp", None, dp), fec_rc=P("pp", None, dp),
        fec_payload=P("pp", None, dp), valid=P("pp", None))
    jitted = {}

    def get(mix_mode):
        if mix_mode not in jitted:
            smapped = jax.shard_map(
                partial(local, mix_mode=mix_mode), mesh=mesh,
                in_specs=(P(None, dp), P(None, dp), P(None), carry_specs,
                          P(dp), P(dp), P(dp)),
                out_specs=(carry_specs, out_specs),
                check_vma=False)
            jitted[mix_mode] = jax.jit(smapped)
        return jitted[mix_mode]

    def run(iq_blocks, carry, tunings=None, bubble=None, dofft=None,
            track_high=None):
        iq = as_cf(iq_blocks)
        n_mb, s = iq.shape[:2]
        if tunings is None:
            tunings = np.full(s, 12000)
        tun_arr = B.tunings_to_nu(tunings)
        assert tun_arr is not None, \
            "pipelined path needs tunings in multiples of 0.1 Hz"
        manual = "pattern" if B.pattern_mix_ok(tunings, rate) else "general"
        dofft_np = np.broadcast_to(
            np.asarray(False if dofft is None else dofft, bool), (s,)).copy()
        th_np = np.broadcast_to(
            np.asarray(False if track_high is None else track_high, bool),
            (s,)).copy()
        if dofft_np.all():
            mix_mode = "dofft"
        elif dofft_np.any():
            mix_mode = f"mixed:{manual}"
        else:
            mix_mode = manual
        if bubble is None:
            bubble = np.zeros(n_mb, bool)
        carry, outs = get(mix_mode)(iq.re, iq.im, np.asarray(bubble, bool),
                                    carry, tun_arr, dofft_np, th_np)
        # the LAST stage produced the real outputs; earlier ranks' slots
        # are dummies
        out = jax.tree.map(lambda x: x[n_stages - 1], outs)
        return out, carry

    run.n_stages = n_stages
    return run


def pipeline_init(cfg: B.BpskConfig, n_streams: int, block_len: int,
                  n_stages: int = 2, max_hits: int = 4):
    """Initial pipeline carry (host numpy; uploads at the first call).

    Layout: every leaf leads with the pp axis [n_stages, ...] — each
    rank owns its own activation buffer and stage state. Initial
    payloads carry valid=False, so the first (n_stages-1) output ticks
    are empty prime ticks."""
    m = cfg.decim
    t_ds = block_len // m

    def stack(x):
        return np.broadcast_to(x, (n_stages, *np.shape(x))).copy()

    with jax.ensure_compile_time_eval():
        p0 = jax.tree.map(np.asarray,
                          _zero_payload(n_streams, t_ds, max_hits))
    buf = jax.tree.map(stack, p0)
    st = jax.tree.map(stack, B.bpsk_init_batch(cfg, n_streams))
    return (buf, st)


def pipeline_flush(run, carry, n_streams: int, block_len: int,
                   tunings=None, ticks: int | None = None, dofft=None,
                   track_high=None) -> Tuple[PipeOut, tuple]:
    """Drain the in-flight blocks: feeds (n_stages-1) BUBBLE ticks —
    inputs marked invalid, so NO stage state advances — and returns the
    decodes of the last real blocks. Safe mid-stream: processing can
    resume with real blocks afterwards and stays bit-identical. Pass the
    session's ``dofft``/``track_high`` flags so the flush reuses the
    same compiled step."""
    n = ticks if ticks is not None else run.n_stages - 1
    z = np.zeros((n, n_streams, block_len), np.complex64)
    out, carry = run(z, carry, tunings, bubble=np.ones(n, bool),
                     dofft=dofft, track_high=track_high)
    return out, carry
