"""Mesh construction helpers."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(dp: Optional[int] = None, sp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("dp", "sp") mesh over the available devices.

    dp shards independent streams/channels (the analog of the reference's
    N FUNcubeBPSKDemod instances, jsdr.java:479-483); sp shards the time
    axis of each stream (overlap-save with halo exchange). Defaults to
    putting all devices on dp.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    assert dp * sp <= n, f"mesh {dp}x{sp} needs more than {n} devices"
    return Mesh(np.array(devs[: dp * sp]).reshape(dp, sp), ("dp", "sp"))


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize multi-host JAX.

    Call once per host before building meshes; after this,
    ``jax.devices()`` spans every host's devices and ``make_mesh`` lays
    dp/sp over them (keep sp within a host, so the per-block halo
    exchanges stay on the host's own device links).
    No-op when already initialized or single-host.
    """
    import jax

    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process
