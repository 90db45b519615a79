"""Out-of-band generator for the golden parity fixtures (run by hand;
the .npz files it writes are COMMITTED and never regenerated in CI).

Each fixture is a recorded IQ capture in the reference's native wire
format (S16LE interleaved, JavaAudio.java:49-57) plus ground truth that
is known BY CONSTRUCTION, not by running the decoder:

- the 256-byte frame payloads fed to the AO-40 encoder (the encoder's
  tables are independently audited against the reference's literals in
  test_transcription_audit.py);
- the clean 5200-symbol soft windows (encoder output mapped to the
  0xc0/0x40 soft bytes of FUNcubeBPSKDemod.java:562-564), for which
  decode must return the payload with rc == 0 channel errors — a
  mathematical contract of the code, with no circularity;
- the channel's rc values and per-block sync hits as recorded at
  generation time (regression anchors for the noisy path).

Usage:  python tests/golden/make_golden.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import jax  # noqa: E402

# the goldens are generated on the CPU, the backend the tests run on
jax.config.update("jax_platforms", "cpu")

from jsdr_tpu.fec.encode import encode_fec40            # noqa: E402
from jsdr_tpu.io.convert import complex_to_s16le        # noqa: E402
from jsdr_tpu.io.sources import synth_bpsk_stream       # noqa: E402


def _soft_window(payload: np.ndarray) -> np.ndarray:
    sym = encode_fec40(payload)
    return np.where(sym > 0, 0xC0, 0x40).astype(np.uint8)


def make(rate: int, n_frames: int, seed: int, noise_rms: float,
         out: Path) -> None:
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (n_frames, 256), dtype=np.uint8)
    iq = synth_bpsk_stream(payloads, rate=rate, carrier_offset=12000.0,
                           preamble_bits=240, noise_rms=noise_rms,
                           seed=seed + 1)
    raw = np.frombuffer(complex_to_s16le(iq), dtype="<i2")
    windows = np.stack([_soft_window(p) for p in payloads])

    # record the decode signature of THIS implementation at generation
    # time (regression anchor; the payload check above it is the
    # construction-derived parity contract)
    import jax.numpy as jnp
    from jsdr_tpu.demod.bpsk import BpskConfig, bpsk_init, bpsk_block
    from jsdr_tpu.fec.decoder import fec_decode
    from jsdr_tpu.io.convert import s16le_to_complex

    sig = s16le_to_complex(raw)
    block = rate
    sig = np.concatenate([sig, np.zeros((-len(sig)) % block, np.complex64)])
    cfg = BpskConfig(rate=rate, tuning=12000.0)
    st = bpsk_init(cfg)
    got, rcs, corrs = [], [], []
    for b in range(len(sig) // block):
        o, st = bpsk_block(jnp.asarray(sig[b * block:(b + 1) * block]),
                           cfg, st)
        nh = int(o.n_hits)
        if nh:
            res = fec_decode(o.windows[:nh])
            for i in range(nh):
                assert bool(res.ok[i])
                got.append(np.asarray(res.payload[i]))
                rcs.append(int(res.rc[i]))
                corrs.append(int(o.hit_corr[i]))
    got = np.stack(got)
    assert got.shape == payloads.shape and np.array_equal(got, payloads), \
        "generation-time decode must recover the constructed payloads"

    np.savez_compressed(
        out, raw_s16le=raw, rate=np.int64(rate), payloads=payloads,
        clean_windows=windows, rc=np.asarray(rcs, np.int64),
        hit_corr=np.asarray(corrs, np.int64), noise_rms=noise_rms,
        tuning=np.int64(12000))
    print(f"{out}: {raw.nbytes/1e6:.1f} MB raw, {n_frames} frames, "
          f"rc={rcs}, corr={corrs}")


if __name__ == "__main__":
    here = Path(__file__).parent
    make(rate=96000, n_frames=2, seed=7, noise_rms=0.5,
         out=here / "golden_96k.npz")
    make(rate=192000, n_frames=1, seed=9, noise_rms=0.4,
         out=here / "golden_192k.npz")
