"""AM / narrow-FM / wide-FM audio demodulation — the batched equivalent of the
per-sample loop at demod.java:398-483.

Everything is one fused XLA graph over a whole block (arbitrarily larger
than the reference's 0.1 s): optional 21-tap band-pass select, optional
down-shift by the filter's low edge, mode demodulation, block AGC. The
carried state (FIR delay tail, carrier phase, FM previous sample) is an
explicit pytree so streams chain seamlessly across blocks and checkpoint
for free (the reference keeps these as mutable fields: demod.java:60-69).
"""

from __future__ import annotations

import enum
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cplx import CF, as_cf, cf_zeros
from ..ops.fir import bandpass_weights, fir_apply_streaming

TWO_PI = 2.0 * np.pi


class Mode(enum.IntEnum):
    """demod.java:39-43."""
    OFF = 0
    RAW = 1
    AM = 2
    NFM = 3
    WFM = 4


class AmFmConfig(NamedTuple):
    rate: int
    mode: int = int(Mode.OFF)
    dofir: bool = False
    dodwn: bool = False
    doagc: bool = False
    flo: int | None = None      # band-pass low edge Hz (None = all-pass)
    fhi: int | None = None
    ntaps: int = 21             # fixed order 20 (demod.java:82-85)
    fir_precision: str = "highest"  # exact-f32 FIR; "bf16x3" = the
                                    # 3-product split of ops.fir (which
                                    # is faster on the GPU is ROADMAP S8)

    def weights(self) -> jnp.ndarray:
        return bandpass_weights(self.ntaps, self.flo, self.fhi, float(self.rate))

    def phi(self) -> float:
        """Down-conversion carrier phase step (demod.java:368)."""
        if self.flo is None:
            return 0.0
        return TWO_PI * (self.flo / float(self.rate))


class AmFmState(NamedTuple):
    fir_tail: CF            # [ntaps-1] planar FIR history
    car: jnp.ndarray        # scalar f32 carrier phase in [0, 2pi)
    last_iq: jnp.ndarray    # [2] f32 previous sample (FM discriminator)

    @staticmethod
    def init(cfg: AmFmConfig) -> "AmFmState":
        # numpy leaves: converted at jit call time (see bpsk_init note)
        return AmFmState(
            fir_tail=cf_zeros(cfg.ntaps - 1),
            car=np.zeros((), np.float32),
            last_iq=np.zeros(2, np.float32),
        )


@partial(jax.jit, static_argnames=("mode", "dofir", "dodwn", "doagc",
                                   "fir_precision"))
def _demod_block(iq, taps, ramp, delta, fmgain, state, *,
                 mode, dofir, dodwn, doagc, fir_precision="highest"):
    x = iq
    fir_tail = state.fir_tail
    if dofir:
        x, fir_tail = fir_apply_streaming(x, taps, fir_tail,
                                          precision=fir_precision)
    car = state.car
    if dodwn:
        # carrier retards by phi per sample, evaluated before the decrement
        # (demod.java:423-434); x * (cos(car) + j sin(car)). ``ramp`` holds
        # mod(t*phi, 2pi) precomputed on host in f64 so long streams do not
        # accumulate f32 phase error. cos/sin of the SHARED ramp are
        # factored out via the angle-sum identity so that under a
        # per-stream vmap the transcendentals evaluate once for the
        # whole batch (the carried phase enters as two scalars) —
        # measured S-fold fewer transcendental ops at S=64
        cr, sr = jnp.cos(ramp), jnp.sin(ramp)        # unbatched in vmap
        cc, cs = jnp.cos(car), jnp.sin(car)          # per-stream scalars
        x = x * CF(cc * cr + cs * sr, cs * cr - cc * sr)
        car = jnp.mod(car - delta, TWO_PI)

    i = x.re.astype(jnp.float32)
    q = x.im.astype(jnp.float32)
    avg = jnp.zeros((), jnp.float32)
    last_iq = state.last_iq
    if mode == Mode.OFF:
        audio = jnp.zeros_like(i)
        mx = jnp.zeros((), jnp.float32)
    elif mode == Mode.RAW:
        audio = i
        mx = jnp.max(jnp.abs(audio))
    elif mode == Mode.AM:
        mag = jnp.sqrt(i * i + q * q)
        avg = jnp.mean(mag)
        audio = mag - avg
        mx = jnp.max(mag) - avg
    else:  # NFM / WFM quadrature-delay discriminator (demod.java:453-460)
        li = jnp.concatenate([last_iq[0][None], i[:-1]])
        lq = jnp.concatenate([last_iq[1][None], q[:-1]])
        audio = (li * q - lq * i) * fmgain
        mx = jnp.max(jnp.abs(audio))
        last_iq = jnp.stack([i[-1], q[-1]])
    if doagc:
        audio = audio * jnp.where(mx > 0, 1.0 / mx, 1.0)
    new_state = AmFmState(fir_tail=fir_tail, car=car, last_iq=last_iq)
    return audio, mx, avg, new_state


def demod_block(iq, cfg: AmFmConfig,
                state: AmFmState) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, AmFmState]:
    """Demodulate one block (CF pair, or host numpy complex64).

    Returns (audio [T] float32 in -1..1, block max, block avg, new state).
    fmgain = rate/5000 (NFM) or rate/75000 (WFM), demod.java:409.
    """
    iq = as_cf(iq)
    fmgain = cfg.rate / (5000.0 if cfg.mode == Mode.NFM else 75000.0)
    taps = cfg.weights()
    phi = cfg.phi()
    n = iq.shape[-1]
    ramp = np.mod(np.arange(n, dtype=np.float64) * phi, TWO_PI).astype(np.float32)
    delta = np.float32(np.mod(n * phi, TWO_PI))
    return _demod_block(
        iq, taps, ramp, delta, np.float32(fmgain), state,
        mode=int(cfg.mode), dofir=cfg.dofir, dodwn=cfg.dodwn,
        doagc=cfg.doagc, fir_precision=cfg.fir_precision,
    )


def audio_to_s16_stereo(audio: jnp.ndarray) -> jnp.ndarray:
    """Duplicate mono audio into interleaved S16LE stereo frames
    (demod.java:473-477)."""
    v = jnp.clip(audio * 32767.0, -32768, 32767).astype(jnp.int16)
    return jnp.stack([v, v], axis=-1).reshape(-1)
