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

A cell of one chip runs all of that in this process on one card.  A cell
of d > 1 chips runs it in d ranks, one process a card joined by the
program's mesh (`run_ranks`, `rank_main`): each rank makes the circuit,
the pool, the zkey on its own card and the same requests, and proves
each through the program's sharded entry; rank 0 owns the clock and the
trace, the peak is the fullest card's, and once every rank has ended
rank 0's proofs are compared with the reference and every other rank's
with rank 0's (`rank_mismatched_proofs`).
"""

from __future__ import annotations

import gc
import json
import os
import pickle
import resource
import shutil
import statistics
import sys
import tempfile
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


@dataclass
class Session:
    """What one rank (the one card's, on a one-card cell) leaves once its
    card state is freed."""

    circuit: object
    toxic: object
    pool: list
    warm: list                         # Proved, each list in request order
    window: list
    traced: list
    t0: float                          # the window's start
    window_s: float
    counts: dict                       # the program's counters across the window
    trace: profile.Trace | None
    setup_peak: int | None             # bytes reserved at the fake setup's end
    peak: int | None                   # bytes reserved from the zkey's first proof on
    kind: str | None                   # the card's name
    used: int | None = None            # a rank's card in use at the end (NVML: context, NCCL)


def session(plan, seed: int, seconds: float, trace: bool, device, started: float,
            mesh=None) -> Session:
    """Set-up, warm-up, window and traced stretch on `device`, then the
    program's state freed.  With a mesh, this is one rank's part: every
    rank makes the same circuit, pool, zkey and requests and proves each
    request through the sharded entry; rank 0 owns the clock (before each
    request it tells every rank whether to go on) and alone runs under the
    profiler, and the traced proofs time the mesh's collectives."""
    import torch

    from . import port

    cfg, traffic = plan.config, plan.traffic
    if traffic.get("loop") != "closed" or int(traffic.get("clients", 1)) != 1:
        raise ValueError("the harness drives one closed-loop client")
    say = log if mesh is None else (lambda msg: log(f"rank {mesh.rank}: {msg}"))
    cuda = torch.device(device).type == "cuda"
    circuit = plan.generator.build(cfg)
    check_sizes(circuit, cfg)
    toxic = draw.toxic(seed)
    pool = draw.pool(plan.generator, circuit, cfg, seed, int(traffic["witness_pool"]))
    wtns = [port.witness(v) for v in pool]
    say(f"circuit {circuit.name} and {len(pool)} witnesses at {time.perf_counter() - started:.3f} s")
    zkey = port.setup(circuit, toxic, cfg["flavour"], device)
    _sync(device)
    say(f"fake setup done at {time.perf_counter() - started:.3f} s")
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
        if mesh is None:
            pts = port.prove(zkey, wtns[i], r, s, device, tim)
        else:
            pts = port.prove_sharded(zkey, wtns[i], r, s, mesh, tim)
        sink.append(Proved(i, r, s, t0, time.perf_counter(), pts, tim))

    warm: list = []
    for _ in range(int(traffic.get("warm_proofs", 1))):
        prove(warm)
    _sync(device)
    say(f"{len(warm)} warm-up proofs done at {time.perf_counter() - started:.3f} s "
        f"({', '.join(f'{p.latency_s:.3f}' for p in warm)} s)")
    before = port.counters(mesh)
    t0 = time.perf_counter()
    window: list = []
    while port.agree(mesh, not window or time.perf_counter() - t0 < seconds):
        prove(window)
    window_s = window[-1].end - t0
    after = port.counters(mesh)

    traced: list = []
    tr = None
    if trace:
        import torch.profiler as tp

        def stretch():
            with port.spans(zkey), port.timed(mesh):
                for _ in range(int(traffic["traced_proofs"])):
                    with tp.record_function("request"):
                        prove(traced)
            return [p.witness for p in traced]

        if mesh is None or mesh.rank == 0:
            tr = profile.profiled(stretch, int(traffic["traced_proofs"]))
        else:
            stretch()
    peak = kind = used = None
    if cuda:
        peak = torch.cuda.max_memory_reserved(device)
        kind = torch.cuda.get_device_name(device)
        if mesh is not None:
            free, total = torch.cuda.mem_get_info(device)
            used = total - free
    del zkey, wtns
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return Session(circuit=circuit, toxic=toxic, pool=pool, warm=warm, window=window,
                   traced=traced, t0=t0, window_s=window_s,
                   counts={k: after.get(k, 0) - before.get(k, 0) for k in ("uploads", "captures")},
                   trace=tr, setup_peak=setup_peak, peak=peak, kind=kind, used=used)


def run(plan, seed: int, seconds: float, trace: bool, device, started: float) -> dict:
    """The result of one run, as `emit` prints it; `started` is the
    process's start on the perf_counter clock.  A cell of one chip runs
    on `device`; a cell of d > 1 chips runs d ranks (`run_ranks`)."""
    if plan.chips > 1:
        return run_ranks(plan, seed, seconds, trace, device, started)
    s = session(plan, seed, seconds, trace, device, started)
    t_ref = time.perf_counter()
    ctx = _context(plan, seed, s, started, s.peak, device)
    checks = compare(s.circuit, s.toxic, s.pool, s.warm + s.window + s.traced)
    log(summary(s.window, s.window_s) + f"; reference {time.perf_counter() - t_ref:.3f} s")
    checks["uploads_in_window"] = [s.counts["uploads"], 0]
    checks["captures_in_window"] = [s.counts["captures"], 0]
    out = _result(checks, len(s.warm) + len(s.window) + len(s.traced),
                  _device(device, max(s.setup_peak or 0, s.peak or 0), s.kind))
    out["metrics"] = read_metrics(plan, ctx, trace)
    return _finish(out, s.trace, checks)


def run_ranks(plan, seed: int, seconds: float, trace: bool, device, started: float) -> dict:
    """One run on `plan.chips` ranks, one process a card (gloo ranks on the
    CPU where `device` is the CPU), each running `rank_main`.  Rank 0's
    window is the run's: its proofs are checked against the reference here,
    once every rank has ended; every other rank's proofs against rank 0's
    for the same request (`rank_mismatched_proofs`).  The peak is the
    fullest card's; uploads and captures are counted across the ranks."""
    from . import port

    out_dir = tempfile.mkdtemp(prefix="proofbench")
    try:
        port.spawn(rank_main, plan.chips, device, plan.cell, plan.config, plan.traffic, seed,
                   seconds, trace, started, out_dir)
        recs = []
        for k in range(plan.chips):
            with open(os.path.join(out_dir, f"rank{k}.pkl"), "rb") as f:
                recs.append(pickle.load(f))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    head = recs[0]
    t_ref = time.perf_counter()
    circuit = plan.generator.build(plan.config)
    pool = draw.pool(plan.generator, circuit, plan.config, seed, int(plan.traffic["witness_pool"]))
    checks = compare(circuit, draw.toxic(seed), pool, head["proofs"])
    log(summary(head["window"], head["window_s"]) + f"; reference {time.perf_counter() - t_ref:.3f} s")
    checks["rank_mismatched_proofs"] = [rank_mismatches([r["proofs"] for r in recs]), 0]
    checks["uploads_in_window"] = [sum(r["counts"]["uploads"] for r in recs), 0]
    checks["captures_in_window"] = [sum(r["counts"]["captures"] for r in recs), 0]
    out = _result(checks, len(head["proofs"]), head["device"])
    out["metrics"] = head["metrics"]
    return _finish(out, head["trace"], checks)


def rank_main(mesh, cell: str, config: dict, traffic: dict, seed: int, seconds: float,
              trace: bool, started: float, out_dir: str) -> None:
    """One rank of `run_ranks` (the program's `launch.spawn` calls it with
    the rank's mesh): its session on mesh.device; once every rank has freed
    its card state, rank 0 reads the cell's metrics (its window and trace,
    the fullest card's peak); each rank pickles what `run_ranks` reads to
    <out_dir>/rank<r>.pkl.  Raises, writing nothing, where the process has
    loaded JAX or the JAX package by then (a reader's imports included)."""
    from . import plan as PL, port
    from ..run import forbidden_modules

    plan = PL.resolve(cell)
    plan.config, plan.traffic, plan.chips = config, traffic, mesh.size
    s = session(plan, seed, seconds, trace, mesh.device, started, mesh)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    log(f"rank {mesh.rank}: card peak {s.peak} bytes ({s.setup_peak} at the fake setup, "
        f"{s.used} in use at the end by NVML), host peak RSS {rss} bytes; "
        + phases("window", s.window) + "; " + phases("traced", s.traced))
    # every rank has freed its card state once this returns
    peaks = port.gather(mesh, (s.setup_peak or 0, s.peak or 0, s.used))
    rec = {"proofs": s.warm + s.window + s.traced, "counts": s.counts}
    if mesh.rank == 0:
        fullest = max(p[1] for p in peaks) if s.peak is not None else None
        each = [max(p[:2]) for p in peaks]
        dev = _device(mesh.device, max(each), s.kind, mesh.size)
        dev["rank_memory_peak_bytes"] = each
        if s.used is not None:
            dev["rank_device_used_bytes"] = [p[2] for p in peaks]
        rec.update(window=s.window, window_s=s.window_s, trace=s.trace, device=dev,
                   metrics=read_metrics(plan, _context(plan, seed, s, started, fullest,
                                                       mesh.device), trace))
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"rank {mesh.rank}: the process loaded {', '.join(found)}")
    with open(os.path.join(out_dir, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(rec, f)


def _context(plan, seed: int, s: Session, started: float, peak, device) -> Context:
    import torch
    cuda = torch.device(device).type == "cuda"
    return Context(seed=seed, config=plan.config, traffic=plan.traffic, circuit=s.circuit,
                   pool=s.pool, window=s.window, window_s=s.window_s, setup_s=s.t0 - started,
                   peak_reserved=peak, trace=s.trace,
                   clock_mhz=sm_clock_max_mhz() if cuda else None)


def _result(checks: dict, attempted: int, device: dict) -> dict:
    return {"correct": all(v <= lim for v, lim in checks.values()), "attempted": attempted,
            "failed": checks["mismatched_proofs"][0], "metrics": {}, "device": device}


def read_metrics(plan, ctx: Context, trace: bool) -> dict:
    """The cell's per-layer metrics with trace, else its end-to-end ones;
    each a reader finds nothing for is left out."""
    out = {}
    t_read = time.perf_counter()
    for m in plan.per_layer if trace else plan.end_to_end:
        value = m.read(ctx)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    log(f"metrics read in {time.perf_counter() - t_read:.3f} s")
    return out


def _finish(out: dict, tr, checks: dict) -> dict:
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["window_s"] = tr.window_s
        top = sorted(tr.ops.items(), key=lambda kv: -kv[1][1])[:10]
        out["breakdown"] = {"device_ops": [[n, t] for n, (_, t) in top],
                            "idle_gaps": [[n, t] for n, t in tr.gaps[:10]]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def rank_mismatches(proofs: list) -> int:
    """Proofs of ranks 1.. (proofs[k]: rank k's Proved, in request order)
    whose request, points or public IO differ from rank 0's for the same
    request; a proof one side lacks counts too."""
    head = proofs[0]
    bad = 0
    for other in proofs[1:]:
        bad += abs(len(other) - len(head))
        bad += sum((a.witness, a.r, a.s, a.points) != (b.witness, b.r, b.s, b.points)
                   for a, b in zip(head, other))
    return bad


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


def phases(label: str, proofs: list) -> str:
    """The mean of each of the proofs' timings, seconds, on one line."""
    keys = [k for k in proofs[0].timings] if proofs else []
    return f"{label} {len(proofs)} proofs, mean " + ", ".join(
        f"{k} {statistics.mean(p.timings.get(k, 0.0) for p in proofs):.6f}" for k in keys)


def _device(device, peak: int, kind: str | None, count: int = 1) -> dict:
    """The line's device: the card's name, the cards used and the fullest
    one's peak."""
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": kind, "count": count, "memory_peak_bytes": int(peak)}


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
