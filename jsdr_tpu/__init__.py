"""jsdr_tpu — a software-defined-radio framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
``phlash/java-sdr`` application:

- IQ ingestion (S16LE interleaved, raw/WAV files, synthetic sources)
- windowed batched FFT spectrum / PSD / waterfall
- FIR design + overlap-save / polyphase-decimation filtering
- AM / narrow-FM / wide-FM audio demodulation
- FUNcube 1200 bps BPSK telemetry demodulation (carrier + symbol timing)
- AO-40 FEC codec: Viterbi(k=7, r=1/2) + 2x shortened RS(255,223)

Unlike the reference (per-sample Java loops on one thread), every
data-parallel stage here is a batched array op compiled by XLA for the
accelerator, the per-sample feedback loops are ``lax.scan`` recurrences
over an explicit state pytree, and multi-device scaling uses
``jax.sharding.Mesh`` + ``shard_map`` with halo exchange for
overlap-save filter boundaries.
"""

__version__ = "0.1.0"
