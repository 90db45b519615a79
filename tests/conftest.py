"""Test harness config: run everything on the CPU with 8 virtual devices,
so the multi-device sharding paths are exercised without accelerators.

The platform is also pinned through jax.config before any backend starts,
so the tests stay on the CPU even where JAX_PLATFORMS is not set. The
persistent compilation cache stays off: every test compiles afresh.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def sine4410(tmp_path):
    """A 2 s capture in the reference's wire format: 44.1 kHz stereo
    S16LE, a 4410 Hz sine on I and silence on Q, written as raw and as
    WAV. Returns {"raw": path, "wav": path, "s16": [frames, 2] int16}."""
    import wave

    rate = 44100
    t = np.arange(2 * rate)
    s16 = np.zeros((len(t), 2), "<i2")
    s16[:, 0] = np.round(16384 * np.sin(2 * np.pi * 4410 * t / rate))
    raw = tmp_path / "sine4410.raw"
    raw.write_bytes(s16.tobytes())
    wav = tmp_path / "sine4410.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(s16.tobytes())
    return {"raw": raw, "wav": wav, "s16": s16}
