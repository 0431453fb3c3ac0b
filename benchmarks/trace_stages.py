"""Device time per named stage, from a jax.profiler trace of a GPU run.

The engines wrap their stages in ``jax.named_scope`` (full_search,
fastme_chain, fastme_window, pred_gather, int_dct).  A kernel's scope path
is its HLO op_name: GPU trace events carry it for some kernels (the ``name``
stat); for the rest the reduction looks the instruction up in XLA's
optimized-HLO dump (``--xla_dump_to``), by the event's ``program_id`` (the
dump file's module number) and ``hlo_op``.  A kernel is charged to the
innermost stage in its path, or to "other".  Kernels that XLA launches
through command buffers (CUDA graphs) are traced one event each all the
same, so the program is traced as it runs by default, with no XLA flag.

The events read follow the backend: on a GPU the ``/device:GPU`` planes
(and none there is an error, never a fallback); on the CPU backend, which
has no device planes, the host events that carry an ``hlo_op`` (the CPU
test suite's rehearsal of the reduction).

    python benchmarks/trace_stages.py TRACE_DIR [DUMP_DIR]   # prints JSON

Used by ``chip_smoke.py --trace``; the numbers are device time (kernel and
copy durations), per traced window marked on the host with
``jax.profiler.TraceAnnotation("window:<name>")``.
"""
from __future__ import annotations

import glob
import json
import os
import re
import sys
from collections import defaultdict

STAGES = ("full_search", "fastme_chain", "fastme_window", "pred_gather", "int_dct")

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")


def stage_of(op_name: str) -> str:
    """Innermost known stage in a named-scope path ("other" if none)."""
    for p in reversed(op_name.split("/")):
        if p in STAGES:
            return p
    return "other"


def op_names(hlo_text: str) -> dict:
    """{instruction: op_name} from one optimized-HLO text."""
    return {m.group(1): m.group(2) for m in map(_INSTR.match, hlo_text.splitlines()) if m}


def dump_op_names(dump_dir: str | None) -> dict:
    """{(program_id, instruction): op_name} over an XLA dump's
    after-optimizations modules (file names carry the module number)."""
    out = {}
    for p in glob.glob(os.path.join(dump_dir or "", "module_*after_optimizations.txt")):
        pid = int(re.match(r"module_(\d+)\.", os.path.basename(p)).group(1))
        with open(p) as f:
            out.update({(pid, k): v for k, v in op_names(f.read()).items()})
    return out


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(trace_dir: str, dump_dir: str | None = None,
                 frames: int | None = None, backend: str | None = None) -> dict:
    """Per traced window: wall span, device busy share, and device ms per
    stage (per frame too when ``frames`` is given); plus the top kernels.
    ``backend`` (default: JAX's default backend) picks the events read."""
    import jax
    from jax.profiler import ProfileData

    backend = backend or jax.default_backend()
    if backend not in ("gpu", "cpu"):
        raise ValueError(f"no trace reduction for backend {backend!r}")
    paths = glob.glob(os.path.join(str(trace_dir), "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(max(paths, key=os.path.getmtime))
    if backend == "gpu" and not any(p.name.startswith("/device:GPU") for p in pd.planes):
        raise RuntimeError(f"the trace under {trace_dir} has no /device:GPU plane")
    dumped = dump_op_names(dump_dir)
    windows, kernels = {}, []
    for plane in pd.planes:
        on_device = plane.name.startswith("/device:GPU")
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                if not on_device:
                    if ev.name.startswith("window:"):
                        windows[ev.name[7:]] = (ev.start_ns, ev.start_ns + ev.duration_ns)
                    if backend == "gpu" or "hlo_op" not in st:
                        continue
                op = str(st.get("hlo_op", ev.name))
                mod = str(st.get("hlo_module", ""))
                path = st.get("name")
                if path is None and "program_id" in st:
                    path = dumped.get((int(st["program_id"]), op))
                kernels.append((ev.start_ns, ev.start_ns + ev.duration_ns,
                                stage_of(str(path or "")), f"{mod}:{op}"))
    if not kernels:
        raise RuntimeError(f"the trace holds no {backend.upper()} kernel events")
    if not windows:
        windows = {"all": (min(k[0] for k in kernels), max(k[1] for k in kernels))}
    out = {}
    for name, (w0, w1) in windows.items():
        ks = [k for k in kernels if k[0] >= w0 and k[1] <= w1]
        per = defaultdict(float)
        for s, e, stage, _ in ks:
            per[stage] += (e - s) / 1e6
        busy_ms = _union([(s, e) for s, e, _, _ in ks]) / 1e6
        span_ms = (w1 - w0) / 1e6
        row = {"span_ms": span_ms, "device_busy_ms": busy_ms,
               "device_idle_share": 1.0 - busy_ms / span_ms if span_ms else None,
               "kernels": len(ks), "stage_ms": dict(sorted(per.items()))}
        if frames:
            row["stage_ms_per_frame"] = {k: v / frames for k, v in sorted(per.items())}
        out[name] = row
    top = defaultdict(float)
    for s, e, stage, key in kernels:
        top[(stage, key)] += (e - s) / 1e6
    out["top_kernels_ms"] = [
        [stage, key, ms] for (stage, key), ms in sorted(top.items(), key=lambda kv: -kv[1])[:25]
    ]
    out["mapped_kernel_share"] = sum(1 for k in kernels if k[2] != "other") / len(kernels)
    return out


if __name__ == "__main__":
    print(json.dumps(reduce_trace(*sys.argv[1:3]), indent=1))
