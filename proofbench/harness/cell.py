"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result's line.

Set-up (counted in setup_s, from the process's start): the circuit from
its generator, the witness pool, the program's fake setup of the zkey on
the card from the seed's toxic waste, and `warm_proofs` proofs, the first
of which uploads the zkey and captures the program's graph.  The device's
memory counters are reset after the zkey is made and before its first
proof.  The window: one closed-loop client proves request after request
(the next witness of the pool, fresh masks) until a proof would start
after `seconds`; the window ends at the last proof's return.  With trace,
`traced_proofs` more proofs run under the profiler.  Then the program's
state is freed and every proof the run made is compared with the
reference's.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import time
from dataclasses import dataclass, field

from . import draw, profile
from .card import sm_clock_max_mhz
from ..reference.groth16 import Reference


@dataclass
class Proved:
    witness: int
    r: int
    s: int
    start: float
    end: float
    points: tuple                      # (pi_a, pi_b, pi_c, public_io)
    timings: dict = field(default_factory=dict)

    @property
    def latency_s(self) -> float:
        return self.end - self.start


@dataclass
class Context:
    """What the metric readers read."""

    seed: int
    config: dict
    traffic: dict
    circuit: object
    pool: list                         # witness values of the pool
    window: list                       # Proved, in the window
    window_s: float
    setup_s: float
    peak_reserved: int | None          # bytes, device memory from the zkey's first proof on
    trace: profile.Trace | None = None
    clock_mhz: float | None = None
    cache: dict = field(default_factory=dict)

    def kernel_seconds(self, *parts: str) -> float | None:
        """Device seconds a traced proof of the operations whose names hold
        one of `parts`; None without a trace or where none ran."""
        if self.trace is None or not self.trace.proofs:
            return None
        hit = [t for name, (_, t) in self.trace.ops.items() if any(p in name for p in parts)]
        return sum(hit) / self.trace.proofs if hit else None

    def once(self, key, make):
        if key not in self.cache:
            self.cache[key] = make()
        return self.cache[key]


def check_sizes(circuit, cfg: dict) -> None:
    """The sizes the configuration states against the circuit made."""
    got = {"constraints": circuit.n_constr, "wires": circuit.n_wires,
           "log2_domain": circuit.log2_domain, "public": circuit.n_pub}
    bad = {k: (cfg[k], v) for k, v in got.items() if k in cfg and cfg[k] != v}
    if bad:
        raise ValueError(f"circuit sizes differ from the configuration (stated, made): {bad}")


def log(msg: str) -> None:
    print(f"proofbench: {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(plan, seed: int, seconds: float, trace: bool, device, started: float) -> dict:
    """The result of one run, as `emit` prints it; `started` is the
    process's start on the perf_counter clock."""
    import torch

    from . import port

    cfg, traffic = plan.config, plan.traffic
    if traffic.get("loop") != "closed" or int(traffic.get("clients", 1)) != 1:
        raise ValueError("the harness drives one closed-loop client")
    cuda = torch.device(device).type == "cuda"
    circuit = plan.generator.build(cfg)
    check_sizes(circuit, cfg)
    toxic = draw.toxic(seed)
    pool = draw.pool(plan.generator, circuit, cfg, seed, int(traffic["witness_pool"]))
    wtns = [port.witness(v) for v in pool]
    log(f"circuit {circuit.name} and {len(pool)} witnesses at {time.perf_counter() - started:.3f} s")
    zkey = port.setup(circuit, toxic, cfg["flavour"], device)
    _sync(device)
    log(f"fake setup done at {time.perf_counter() - started:.3f} s")
    setup_peak = None
    if cuda:
        setup_peak = torch.cuda.max_memory_reserved(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    reqs = draw.requests(seed, len(pool))

    def prove(sink: list):
        i, r, s = next(reqs)
        tim: dict = {}
        t0 = time.perf_counter()
        pts = port.prove(zkey, wtns[i], r, s, device, tim)
        sink.append(Proved(i, r, s, t0, time.perf_counter(), pts, tim))

    warm: list = []
    for _ in range(int(traffic.get("warm_proofs", 1))):
        prove(warm)
    _sync(device)
    log(f"{len(warm)} warm-up proofs done at {time.perf_counter() - started:.3f} s "
        f"({', '.join(f'{p.latency_s:.3f}' for p in warm)} s)")
    before = port.counters()
    t0 = time.perf_counter()
    window: list = []
    while not window or time.perf_counter() - t0 < seconds:
        prove(window)
    window_s = window[-1].end - t0
    after = port.counters()

    traced: list = []
    tr = None
    if trace:
        import torch.profiler as tp

        def stretch():
            with port.spans(zkey):
                for _ in range(int(traffic["traced_proofs"])):
                    with tp.record_function("request"):
                        prove(traced)
            return [p.witness for p in traced]

        tr = profile.profiled(stretch, int(traffic["traced_proofs"]))
    peak = None
    if cuda:
        peak = torch.cuda.max_memory_reserved(device)
    device_info = _device(device, max(setup_peak or 0, peak or 0))
    del zkey, wtns
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ctx = Context(seed=seed, config=cfg, traffic=traffic, circuit=circuit, pool=pool,
                  window=window, window_s=window_s, setup_s=t0 - started, peak_reserved=peak,
                  trace=tr, clock_mhz=sm_clock_max_mhz() if cuda else None)
    checks = compare(circuit, toxic, pool, warm + window + traced)
    log(summary(window, window_s) + f"; reference {time.perf_counter() - t_ref:.3f} s")
    checks["uploads_in_window"] = [after.get("uploads", 0) - before.get("uploads", 0), 0]
    checks["captures_in_window"] = [after.get("captures", 0) - before.get("captures", 0), 0]
    metrics = plan.per_layer if trace else plan.end_to_end
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": len(warm) + len(window) + len(traced),
           "failed": checks["mismatched_proofs"][0],
           "metrics": {}, "device": device_info}
    t_read = time.perf_counter()
    for m in metrics:
        value = m.read(ctx)
        if value is not None:
            out["metrics"][m.name] = {"value": float(value), "unit": m.unit}
    log(f"metrics read in {time.perf_counter() - t_read:.3f} s")
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["window_s"] = tr.window_s
        top = sorted(tr.ops.items(), key=lambda kv: -kv[1][1])[:10]
        out["breakdown"] = {"device_ops": [[n, t] for n, (_, t) in top],
                            "idle_gaps": [[n, t] for n, t in tr.gaps[:10]]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def compare(circuit, toxic, pool: list, proofs: list) -> dict:
    """[value, limit] of each number compared: proofs whose points or public
    IO differ from the reference's, and rows of the pool's witnesses that
    the circuit does not accept (the benchmark's own inputs)."""
    ref = Reference(circuit, toxic)
    terms = {i: ref.terms(pool[i]) for i in sorted({p.witness for p in proofs})}
    bad = 0
    for p in proofs:
        t = terms[p.witness]
        if tuple(p.points[:3]) != ref.proof(t, p.r, p.s) or list(p.points[3]) != t.public_io:
            bad += 1
    return {"mismatched_proofs": [bad, 0],
            "unsatisfied_rows": [sum(t.unsatisfied for t in terms.values()), 0]}


def summary(window: list, window_s: float) -> str:
    """The window on one line of standard error: latency quantiles, the
    program's replay and host times a proof, and the mean latency of the
    window's first and last tenth (a slow start shows there)."""
    lat = [p.latency_s for p in window]
    tenth = len(lat) // 10 + 1
    out = (f"window {len(window)} proofs in {window_s:.3f} s, latency ms p50 "
           f"{1e3 * quantile(lat, 0.5):.3f} p95 {1e3 * quantile(lat, 0.95):.3f} "
           f"max {1e3 * max(lat):.3f}")
    tim = [p.timings for p in window if "device_core_s" in p.timings]
    if tim:
        core = 1e3 * statistics.mean(t["device_core_s"] for t in tim)
        host = 1e3 * statistics.mean(t["total_s"] - t["device_core_s"] for t in tim)
        out += f", replay to host {core:.3f} and host {host:.3f} ms a proof"
    return out + (f"; first and last tenth {1e3 * statistics.mean(lat[:tenth]):.3f}, "
                  f"{1e3 * statistics.mean(lat[-tenth:]):.3f} ms")


def _device(device, peak: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(peak)}


def emit(out: dict) -> None:
    """The checks on standard error's last lines, then the result's line."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def quantile(values, q: float) -> float:
    """The q-th quantile of values, linear between order statistics."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    return statistics.quantiles(xs, n=100, method="inclusive")[round(q * 100) - 1]
