"""Golden parity fixtures: committed IQ captures with construction-known
ground truth (see tests/golden/make_golden.py for provenance).

The parity contract (BASELINE.json): bit-exact AO-40 frame recovery on
recorded IQ. Both the parallel timing path and the
``compat_scan`` per-sample path must recover the exact committed
payloads; the clean soft windows must decode with rc == 0 (a
construction-derived contract with no decoder circularity). Covers both
the 96 kS/s (FCD V1) and 192 kS/s (FCD V2, decim=20, jsdr.java:271-277)
chains.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from jsdr_tpu.demod.bpsk import BpskConfig, bpsk_init, bpsk_block
from jsdr_tpu.fec.decoder import fec_decode
from jsdr_tpu.io.convert import s16le_to_complex

GOLDEN = Path(__file__).parent / "golden"
FIXTURES = ["golden_96k.npz", "golden_192k.npz"]


def _load(name):
    return np.load(GOLDEN / name)


def _decode_capture(sig, rate, tuning, compat_scan):
    block = rate
    sig = np.concatenate([sig, np.zeros((-len(sig)) % block, np.complex64)])
    cfg = BpskConfig(rate=rate, tuning=float(tuning),
                     compat_scan=compat_scan)
    st = bpsk_init(cfg)
    payloads, rcs, corrs = [], [], []
    for b in range(len(sig) // block):
        o, st = bpsk_block(jnp.asarray(sig[b * block:(b + 1) * block]),
                           cfg, st)
        nh = int(o.n_hits)
        if nh:
            res = fec_decode(o.windows[:nh])
            for i in range(nh):
                assert bool(res.ok[i])
                payloads.append(np.asarray(res.payload[i]))
                rcs.append(int(res.rc[i]))
                corrs.append(int(o.hit_corr[i]))
    return np.stack(payloads), rcs, corrs


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("compat_scan", [False, True],
                         ids=["parallel", "compat_scan"])
def test_golden_capture_decodes_bit_exact(name, compat_scan):
    g = _load(name)
    sig = s16le_to_complex(np.asarray(g["raw_s16le"]))
    got, rcs, corrs = _decode_capture(
        sig, int(g["rate"]), int(g["tuning"]), compat_scan)
    assert np.array_equal(got, g["payloads"]), "payloads must be bit-exact"
    assert rcs == list(g["rc"]), (rcs, g["rc"])
    assert corrs == list(g["hit_corr"])


@pytest.mark.parametrize("name", FIXTURES)
def test_golden_clean_windows_decode_rc0(name):
    """decode(encode(p)) == p with zero channel errors — construction-
    derived, independent of the demodulator entirely."""
    g = _load(name)
    res = fec_decode(jnp.asarray(g["clean_windows"]))
    assert bool(res.ok.all())
    assert np.array_equal(np.asarray(res.payload), g["payloads"])
    assert np.asarray(res.rc).tolist() == [0] * len(g["payloads"])


def test_golden_fixture_integrity():
    """The committed fixtures carry consistent shapes and wire format."""
    for name in FIXTURES:
        g = _load(name)
        raw = np.asarray(g["raw_s16le"])
        assert raw.dtype == np.int16 and raw.size % 2 == 0
        assert g["payloads"].shape[1:] == (256,)
        assert g["clean_windows"].shape[1:] == (5200,)
        assert set(np.unique(g["clean_windows"])) <= {0x40, 0xC0}
