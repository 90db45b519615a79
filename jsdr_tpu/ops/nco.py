"""Numerically-controlled oscillators and mixers.

The reference advances a phase accumulator one sample at a time and looks
up 256-entry sin/cos tables (FUNcubeBPSKDemod.java:93-95, 381-397,
511-516; demod.java:423-434). Because every phase increment is constant,
the whole phase trajectory is a closed-form ramp — so here the NCO is a
vectorized elementwise op, not a recurrence. The carried state is just the
scalar starting phase (an explicit state pytree field), which keeps
checkpoint/resume and block chaining exact.

Two flavours:

- ``quantized``: reproduces the reference's table quantization and its
  non-complex mix quirk (i*cos, q*sin — NOT a complex multiply), needed
  for frame-level parity with the Java demodulator.
- clean complex mixers (``mix_complex``) for the performance path.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

SINCOS_SIZE = 256  # FUNcubeBPSKDemod.java:93
TWO_PI = 2.0 * jnp.pi


def quantized_cos_sin(phase: jnp.ndarray, dtype=jnp.float32) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """cos/sin via the reference's 256-entry table quantization.

    Index = ((int)(phase * 256 / 2pi)) % 256 (FUNcubeBPSKDemod.java:389-390);
    the table itself holds sin/cos at exact bin centers (:159-162).
    """
    idx = (phase * (SINCOS_SIZE / TWO_PI)).astype(jnp.int32) % SINCOS_SIZE
    ang = idx.astype(dtype) * (TWO_PI / SINCOS_SIZE)
    return jnp.cos(ang).astype(dtype), jnp.sin(ang).astype(dtype)


def phase_ramp(n: int, phase0: jnp.ndarray, inc,
               chunk: int = 2048) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Phases produced by ``for t: phase += inc; wrap 2pi`` starting at
    ``phase0`` — i.e. sample t sees phase0 + (t+1)*inc, wrapped.

    Works in f32 without x64: when ``inc`` is a python float (static
    frequency — the common case), the ramp is computed on host in f64
    and baked as a constant. For a traced ``inc``, a coarse/fine split
    bounds the f32 rounding error to ~(n/chunk + chunk) ulps of 2pi
    instead of ~n. Returns (phases[n], final_phase).
    """
    if isinstance(inc, (int, float)):
        ramp = np.mod(np.arange(1, n + 1, dtype=np.float64) * float(inc),
                      TWO_PI).astype(np.float32)
        phases = jnp.mod(phase0.astype(jnp.float32) + jnp.asarray(ramp), TWO_PI)
        return phases, phases[-1]
    inc = jnp.asarray(inc, jnp.float32)
    t = jnp.arange(1, n + 1)
    coarse = (t // chunk).astype(jnp.float32)
    fine = (t % chunk).astype(jnp.float32)
    inc_c = jnp.mod(chunk * inc, TWO_PI)
    phases = jnp.mod(phase0.astype(jnp.float32)
                     + jnp.mod(coarse * inc_c, TWO_PI) + fine * inc, TWO_PI)
    return phases, phases[-1]


def mix_quirk(i: jnp.ndarray, q: jnp.ndarray, phases: jnp.ndarray,
              dtype=jnp.float32) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The reference's non-complex mix: (i*cos(p), q*sin(p))
    (FUNcubeBPSKDemod.java:389-390 and :515-516)."""
    c, s = quantized_cos_sin(phases, dtype)
    return i * c, q * s


def mix_complex(iq: jnp.ndarray, phases: jnp.ndarray) -> jnp.ndarray:
    """Clean complex mixer: iq * exp(-1j*phase) (down-conversion)."""
    rot = jnp.exp(-1j * phases).astype(iq.dtype)
    return iq * rot


def tuner_mix(i: jnp.ndarray, q: jnp.ndarray, phase0, inc,
              compat: bool = True):
    """Software tuner front-end (FUNcubeBPSKDemod.java:366-397).

    Mixes only where the running phase is > 0 (with inc <= 0 the phase
    never goes positive, so the signal passes through — reference
    behavior at :388-396). Returns (mi, mq, final_phase).
    """
    phases, phase_out = phase_ramp(i.shape[-1], jnp.asarray(phase0), inc)
    mi, mq = mix_quirk(i, q, phases, dtype=i.dtype) if compat else _cmix(i, q, phases)
    use = phases > 0.0
    return jnp.where(use, mi, i), jnp.where(use, mq, q), phase_out


def _cmix(i, q, phases):
    c = jnp.cos(phases).astype(i.dtype)
    s = jnp.sin(phases).astype(i.dtype)
    return i * c + q * s, q * c - i * s
