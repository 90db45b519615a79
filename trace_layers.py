#!/usr/bin/env python3
"""Per-layer device time and idle share of the flagship step, from
profiler traces.

Run from the repository root on the GPU:

    python trace_layers.py [--steps N] [--streams S] [--out DIR]

Traces N steps (default 3) of the 96 kS/s flagship step (display
spectrum + FUNcube telemetry chain, S = 128 streams x 4.8 s, the bench
width) followed by the FEC decode of one sync window per stream. The
steps are dispatched back to back, state chained, with one wait at the
end, so no host sync between steps counts as idle time.

The step is compiled twice. As compiled for production, XLA runs its
kernels inside command buffers (CUDA graphs), whose kernels reach the
trace under one op name: that trace gives the step's wall time, the
device's busy time and its idle share. The second compile turns command
buffers off (compile option ``xla_gpu_enable_command_buffer`` empty), so
every kernel names its HLO op; its events are reduced to the layers the
code labels with ``jax.named_scope``: spectrum, mix_decimate (tuner mix
+ decimating FIR), vco_mf (VCO + matched filter), timing, sync (bit
compaction + sync search + window extraction) and fec. An event's layer
is read from the ``op_name`` metadata of its HLO instruction in the
optimized program (for a fusion: of the instructions it fuses). Kernel
times do not depend on command buffers; the gaps between kernels do.

Prints the production step's wall, busy and idle time, each layer's
device time per step beside its memory-traffic bound (minimum bytes
over 3.35 TB/s, the H100 SXM's HBM bandwidth), and the top device
operations. The traces are left in DIR/trace (default chiprun_out/).
"""

from __future__ import annotations

import argparse
import collections
import glob
import re
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
LAYERS = ("spectrum", "mix_decimate", "vco_mf", "timing", "sync", "fec")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)


def layer_bytes(s: int, t: int, rate: int) -> dict:
    """Least device-memory traffic of each layer for one step over
    [s, t] f32 planar IQ: every input read once, every output written
    once (m = rate / 9600, n = rate / 10, 1920-pixel lines)."""
    m, n = rate // 9600, rate // 10
    iq, ds = 8 * s * t, 8 * s * t // m          # planar f32 pairs
    return {
        "spectrum": iq + 4 * s * (t // n) * (1920 + 2),
        "mix_decimate": iq + ds,
        "vco_mf": 2 * ds,
        "timing": ds + 2 * s * (2 * t // m // 8),
        "sync": 2 * s * (2 * t // m // 8) + s * 4 * 5200,
        "fec": s * (5200 + 256),
    }


def layer_of(op_name: str):
    parts = set(re.split(r"[/()]", op_name))
    return next((lay for lay in LAYERS if lay in parts), None)


def hlo_layers(hlo_text: str) -> dict:
    """instruction name -> layer, from the optimized HLO's metadata;
    fusions and calls fall back to the instructions they call."""
    own, calls, comp_ops = {}, {}, collections.defaultdict(list)
    comp = None
    for line in hlo_text.splitlines():
        head = re.match(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if head and "=" not in line.split("{")[0]:
            comp = head.group(1)
            continue
        m = re.match(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        if not m:
            continue
        name = m.group(1)
        op = re.search(r'op_name="([^"]*)"', line)
        lay = layer_of(op.group(1)) if op else None
        own[name] = lay
        if lay and comp:
            comp_ops[comp].append(lay)
        c = re.search(r"calls=%?([\w.\-]+)", line)
        if c:
            calls[name] = c.group(1)
    out = {}
    for name, lay in own.items():
        if lay is None and name in calls:
            votes = collections.Counter(comp_ops.get(calls[name], []))
            lay = votes.most_common(1)[0][0] if votes else None
        out[name] = lay or "other"
    return out


def device_events(xplane: str):
    """[(hlo_op, hlo_module, start_ns, dur_ns)] of the device planes'
    operation events (the per-stream kernel lines if the plane has no
    'XLA Ops' line)."""
    import jax
    pd = jax.profiler.ProfileData.from_file(xplane)
    evs = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines if ln.name.startswith("Stream")]
        for ln in ops:
            for e in ln.events:
                st = dict(e.stats)
                op = st.get("hlo_op")
                if op is None:
                    continue
                evs.append((str(op), str(st.get("hlo_module", "")),
                            float(e.start_ns), float(e.duration_ns)))
    return evs


def busy_ns(evs) -> float:
    """Union length of the event intervals."""
    iv = sorted((s, s + d) for _, _, s, d in evs)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--streams", type=int, default=128)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)

    import jax
    sys.path.insert(0, str(ROOT))
    from jsdr_tpu.demod.bpsk import (BpskConfig, bpsk_block_batch_spectrum,
                                     bpsk_init_batch)
    from jsdr_tpu.fec.decoder import fec_decode
    from jsdr_tpu.io.sources import synth_bpsk_stream
    from jsdr_tpu.ops.cplx import from_complex
    from jsdr_tpu.runtime.device import init_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"trace_layers: no GPU found (JAX platform is "
                         f"{dev.platform!r})")
    init_compile_cache()
    rate, s, t = 96000, args.streams, 460800
    cfg = BpskConfig(rate=rate, tuning=12000.0)
    base = synth_bpsk_stream(
        np.random.default_rng(0).integers(0, 256, (2, 256), dtype=np.uint8),
        rate=rate, preamble_bits=400, noise_rms=0.3)
    sig = np.tile(base, -(-s * t // len(base)))[:s * t].reshape(s, t)
    iq = jax.device_put(from_complex(sig))
    st = jax.device_put(bpsk_init_batch(cfg, s))

    def step(iq, st):
        spec, out, st = bpsk_block_batch_spectrum(iq, cfg, st)
        fec = fec_decode(out.windows[:, 0])
        return spec, out, fec, st

    lowered = jax.jit(step).lower(iq, st)
    tdir = Path(args.out) / "trace"
    k = args.steps

    def traced(compiled, name: str):
        """(events of the busiest module, wall seconds) of k steps."""
        s_ = st
        for _ in range(2):
            res = jax.block_until_ready(compiled(iq, s_))
            s_ = res[-1]
        jax.profiler.start_trace(str(tdir / name))
        t0 = time.perf_counter()
        for _ in range(k):
            res = compiled(iq, s_)
            s_ = res[-1]
        jax.block_until_ready(res)
        wall = time.perf_counter() - t0
        jax.profiler.stop_trace()
        xplane = sorted(glob.glob(str(tdir / name / "**" / "*.xplane.pb"),
                                  recursive=True))[-1]
        evs = device_events(xplane)
        module = collections.Counter(m for _, m, _, _ in evs).most_common(1)
        return [e for e in evs if module and e[1] == module[0][0]], wall

    evs, wall = traced(lowered.compile(), "production")
    busy = busy_ns(evs) / 1e9
    print(f"device: {dev.device_kind}; production step (command buffers "
          f"on), {k} steps: wall {wall / k * 1e3:.3f} ms/step, device busy "
          f"{busy / k * 1e3:.3f} ms/step, idle {1 - busy / wall:.1%}")
    split = lowered.compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    layer = hlo_layers(split.as_text())
    evs, wall = traced(split, "split")
    print(f"command buffers off: {len(evs)} device events over {k} steps; "
          f"wall {wall / k * 1e3:.3f} ms/step (kernel launches), device "
          f"busy {busy_ns(evs) / 1e6 / k:.3f} ms/step")

    per_op = collections.defaultdict(lambda: [0, 0.0])
    per_layer = collections.defaultdict(float)
    for op, _, _, dur in evs:
        per_op[op][0] += 1
        per_op[op][1] += dur
        per_layer[layer.get(op, "other")] += dur
    bound = layer_bytes(s, t, rate)
    print("layer, device ms/step, share, bytes/3.35 TB/s bound ms")
    tot = sum(per_layer.values()) or 1.0
    for lay in LAYERS + ("other",):
        ns = per_layer.get(lay, 0.0)
        b = bound.get(lay)
        print(f"  {lay:13s} {ns / 1e6 / k:9.4f}  {ns / tot:6.1%}  "
              + ("" if b is None else f"{b / HBM_BYTES_PER_S * 1e3:.4f}"))
    top = sorted(per_op.items(), key=lambda kv: -kv[1][1])[:20]
    print("top device operations: hlo_op, layer, calls/step, ms/step")
    for op, (n, dur) in top:
        print(f"  {op:40s} {layer.get(op, 'other'):13s} {n / k:6.1f} "
              f"{dur / 1e6 / k:9.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
