"""The one-dispatch prover on the CPU (groth16_tpu_torch/protocol/
prover.py: `generate_proof_with_mask`, `prove_core_device`, its spec-point
algebra): the CPU proof of synthetic_circuit(5) (the naive MSMs), the core
run eagerly through the plain versions, equals the host-int oracle
(`fused_cases.oracle_proofs`) under the masks (0, 0), a fixed pair and
(q - 1, q - 1); the device algebra's window tables and ladders equal the
host-int group law for scalars 0, 1, q - 1 and random ones, G1 and G2; a
CUDA graph on a CPU device raises.  The tracer's view of the same runs:
the core's nine phase marks, the CPU proof's timings, the fake setup's
spans, and the CUDA path's timings and spans around a stand-in graph.  The
slow lane runs the whole CPU proof against the oracle in both flavours at
both sizes.  tests/test_torch_fused_guard.py holds JensGroth at the fold's
size and the capture guard; tests/test_torch_gpu.py the captured graph on
the card."""

import threading

import numpy as np
import pytest
import torch

from fused_cases import CPU, MASKS, PROOF_KEYS, Q, cpu_proofs, oracle_proofs, points, \
    shared_msms
from test_snarkjs_golden import FIXED_TOXIC

import groth16_tpu_torch as T
from groth16_tpu_torch.models.circuits import synthetic_circuit
from groth16_tpu_torch.ops import curve as C
from groth16_tpu_torch.ops.limbs import ints_to_limbs
from groth16_tpu_torch.protocol import prover as PV
from groth16_tpu_torch.utils import hostmath as H
from groth16_tpu_torch.utils import timing as TR

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

RNG = np.random.default_rng(11)
SCALARS = [0, 1, Q - 1] + [int.from_bytes(RNG.bytes(32), "little") % Q for _ in range(2)]


@pytest.fixture(scope="module")
def snarkjs5():
    """(zkey, witness, the oracle's proofs under MASKS, the CPU proofs under
    MASKS and the first one's timings, traced, and (the phases a marker
    saw, the proof buffer) of `prove_core_device` whole under MASKS[1] with
    that marker); all share their MSM results (`shared_msms`)."""
    r1cs, wtns = synthetic_circuit(5)
    zkey = T.fake_circuit_setup(r1cs, T.ToxicWaste(**FIXED_TOXIC), T.Flavour.Snarkjs, CPU)
    hdr = zkey.header
    with shared_msms():
        oracle = oracle_proofs(zkey, wtns, MASKS)
        cpu, timings = cpu_proofs(zkey, wtns, MASKS)
        marks: list = []
        buf = PV.prove_core_device(hdr.flavour, hdr.log_domain_size, PV.zkey_device_args(zkey, CPU),
                                   PV.spec_args(zkey, CPU), torch.from_numpy(wtns.values),
                                   torch.from_numpy(PV.mask_limbs(MASKS[1])), marks.append)
        return zkey, wtns, oracle, (cpu, timings), (marks, buf)


@pytest.mark.parametrize("i", range(len(MASKS)), ids=["zero", "fixed", "q-1"])
def test_core_equals_staged(snarkjs5, i):
    """The CPU proof equals the host-int oracle's and verifies."""
    zkey, _, oracle, (cpu, _), _ = snarkjs5
    assert points(cpu[i]) == points(oracle[i])
    assert cpu[i].public_io == oracle[i].public_io
    assert T.verify_proof(T.extract_vkey(zkey), cpu[i])


def test_default_on_cpu_is_staged(snarkjs5):
    """A traced CPU proof's timings have the CUDA path's keys (no capture
    on the CPU): upload_s, device_core_s, total_s and each phase's seconds."""
    _, _, _, (_, timings), _ = snarkjs5
    assert set(timings) == PROOF_KEYS
    assert all(v >= 0.0 for v in timings.values())
    assert timings["total_s"] >= timings["upload_s"] + timings["device_core_s"]


def test_fused_on_cpu_raises(snarkjs5):
    """A CUDA graph of a proof needs a CUDA device."""
    zkey, _, _, _, _ = snarkjs5
    with pytest.raises(ValueError):
        PV.FusedProof(zkey, CPU)
    with pytest.raises(ValueError):
        PV.fused_graph(zkey, CPU)
    assert not any(isinstance(k, tuple) and k[0] == "fused" for k in zkey.device_cache)


def _curve(name):
    return (C.G1, H.g1_mul, H.g1_add) if name == "G1" else (C.G2, H.g2_mul, H.g2_add)


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_table_mul_matches_host(name):
    cv, mul, _ = _curve(name)
    base = mul(0x5EED_1234_5678)
    table = C.window_table(cv, base, PV.SPEC_WINDOW, CPU)
    got = C.points_to_host(cv, PV.table_mul(cv, table, torch.from_numpy(ints_to_limbs(SCALARS))))
    assert got == [mul(k, base) if k else None for k in SCALARS]


@pytest.mark.parametrize("name", ["G1", "G2"])
def test_window_mul_matches_host(name):
    cv, mul, _ = _curve(name)
    bases = [mul(7 + 3 * i) for i in range(len(SCALARS))]
    bases[1] = None                                   # 1 * infinity
    P = C.points_from_host(cv, bases, CPU)
    got = C.points_to_host(cv, PV.window_mul(cv, P, torch.from_numpy(ints_to_limbs(SCALARS))))
    assert got == [mul(k, b) if k and b is not None else None for k, b in zip(SCALARS, bases)]


def test_multiples_are_the_small_multiples():
    base = H.g2_mul(99)
    got = C.points_to_host(C.G2, C.multiples(C.G2, C.points_from_host(C.G2, [base], CPU), 3))
    assert got == [None] + [H.g2_mul(99 * d) for d in range(1, 8)]


@pytest.mark.parametrize("r,s", [(0, 0), (1, 1), (Q - 1, Q - 1), (SCALARS[3], SCALARS[4])],
                         ids=["zero", "one", "q-1", "random"])
def test_spec_algebra_matches_host(snarkjs5, r, s):
    """The algebra of prover.nim:278-302 on random MSM points, against the
    host formula."""
    zkey = snarkjs5[0]
    spec = zkey.spec
    g1 = [H.g1_mul(5 + i) for i in range(4)]
    g2 = H.g2_mul(77)
    msms = [C.points_from_host(cv, [pt], CPU) for cv, pt in
            ((C.G1, g1[0]), (C.G1, g1[1]), (C.G2, g2), (C.G1, g1[2]), (C.G1, g1[3]))]
    got = PV.proof_points(PV.proof_buffer(*PV.spec_algebra(
        PV.spec_device_args(zkey, CPU), [tuple(c[0] for c in P) for P in msms],
        torch.from_numpy(PV.mask_limbs(T.Mask(r, s))))))
    pi_a = H.g1_add(H.g1_add(spec.alpha1, H.g1_mul(r, spec.delta1)), g1[0])
    rho = H.g1_add(H.g1_add(spec.beta1, H.g1_mul(s, spec.delta1)), g1[1])
    pi_b = H.g2_add(H.g2_add(spec.beta2, H.g2_mul(s, spec.delta2)), g2)
    pi_c = H.g1_add(H.g1_mul(s, pi_a), H.g1_mul(r, rho))
    for pt in (H.g1_mul((-r * s) % Q, spec.delta1), g1[2], g1[3]):
        pi_c = H.g1_add(pi_c, pt)
    assert got == (pi_a, pi_b, pi_c)


def test_mask_limbs():
    limbs = PV.mask_limbs(T.Mask(Q + 5, 2 * Q - 3))
    assert limbs.dtype == np.uint32 and limbs.shape == (3, 16)
    got = [sum(int(v) << (16 * j) for j, v in enumerate(row)) for row in limbs]
    assert got == [5, Q - 3, (-5 * (Q - 3)) % Q]


@pytest.mark.slow
@pytest.mark.parametrize("log2", [5, 8], ids=["naive", "fold"])
@pytest.mark.parametrize("flavour", ["snarkjs", "jens-groth"])
def test_prove_core_device_equals_staged_proof(flavour, log2):
    """`prove_core_device` whole against the host-int oracle, both
    flavours, at the naive MSMs' size and at the fold's (about 30 s a case
    on one core)."""
    r1cs, wtns = synthetic_circuit(log2)
    zkey = T.fake_circuit_setup(r1cs, T.ToxicWaste(**FIXED_TOXIC), T.Flavour(flavour), CPU)
    (want,) = oracle_proofs(zkey, wtns, MASKS[1:2])
    hdr = zkey.header
    buf = PV.prove_core_device(hdr.flavour, hdr.log_domain_size, PV.zkey_device_args(zkey, CPU),
                               PV.spec_device_args(zkey, CPU), torch.from_numpy(wtns.values),
                               torch.from_numpy(PV.mask_limbs(MASKS[1])))
    assert PV.proof_points(buf) == points(want)


def test_core_marks_the_nine_phases_in_order(snarkjs5):
    """`prove_core_device` with a marker calls it once at the end of each
    phase, in order, and gives the proof it gives without one."""
    _, _, _, (cpu, _), (marks, buf) = snarkjs5
    assert marks == list(TR.PHASES)
    assert PV.proof_points(buf) == points(cpu[1])


def test_fake_setup_records_its_steps(snarkjs5):
    """The fixture's fake setup is the span `fake_setup` with its five
    steps as children, in order, recorded with tracing off."""
    recs = TR.records()
    roots = [r for r in recs if r.name == "fake_setup"]
    assert roots
    root = roots[-1]
    kids = [r for r in recs if r.parent == root.index]
    assert [r.name for r in kids] == ["fake_setup.spec", "fake_setup.terms", "fake_setup.taus",
                                      "fake_setup.points", "fake_setup.coeffs"]
    assert all(root.start_ns <= k.start_ns <= k.end_ns <= root.end_ns for k in kids)


class _Replayed:
    """A captured FusedProof's stand-in on the CPU: `load` keeps nothing,
    `replay` returns a fixed proof buffer and, while tracing is on, fixed
    device phases, as the graph's timing events would give them."""

    def __init__(self, buf):
        self.lock = threading.Lock()
        self.buf = buf.numpy()
        self.phases: dict = {}

    def load(self, wtns, mask):
        pass

    def replay(self):
        self.phases = {p: 1e-3 * (i + 1) for i, p in enumerate(TR.PHASES)} if TR.on() else {}
        if self.phases:
            TR.record_phases(self.phases)
        return self.buf


@pytest.fixture
def replayed(snarkjs5, monkeypatch):
    """`fused_graph` on the CPU gives a `_Replayed` of the fixture's marked
    proof, kept in the zkey's cache (taken out after the test)."""
    zkey, wtns, _, (cpu, _), (_, buf) = snarkjs5
    key = PV._fused_key(zkey, CPU)

    def graph(zk, device):
        return zk.device_cache.setdefault(key, _Replayed(buf))

    monkeypatch.setattr(PV, "fused_graph", graph)
    TR.disable()
    yield zkey, wtns, points(cpu[1])
    TR.disable()
    zkey.device_cache.pop(key, None)


def test_fused_timings_keys_are_unchanged(replayed):
    """The CUDA path's timings keys (`_prove` with `_replay`) with tracing
    off: capture_s on the proof that captured, then upload_s, device_core_s
    and total_s."""
    zkey, wtns, points_ = replayed
    keys = {"upload_s", "device_core_s", "total_s"}
    sinks = [{}, {}]
    for sink in sinks:
        prf = PV._prove(zkey, wtns, MASKS[1], CPU, sink, PV._replay)
        assert (prf.pi_a, prf.pi_b, prf.pi_c) == points_
    assert set(sinks[0]) == keys | {"capture_s"} and set(sinks[1]) == keys
    assert all(v >= 0.0 for s in sinks for v in s.values())
    assert sinks[1]["total_s"] >= sinks[1]["upload_s"] + sinks[1]["device_core_s"]


def test_fused_proof_spans_share_one_proof_id(replayed):
    """Traced, a proof of the CUDA path is the root span `proof` over `public_io`,
    `load`, `device_core` and `proof_points`, one proof id each proof, and
    its timings carry each phase's device seconds as `<phase>_device_s`."""
    zkey, wtns, _ = replayed
    TR.enable()
    first = len(TR.records())
    sinks = [{}, {}]
    for sink in sinks:
        PV._prove(zkey, wtns, MASKS[1], CPU, sink, PV._replay)
    TR.disable()
    recs = TR.records()[first:]
    roots = [r for r in recs if r.name == "proof"]
    assert len(roots) == 2 and roots[0].proof != roots[1].proof
    for root in roots:
        kids = [r.name for r in recs if r.parent == root.index]
        assert kids == ["public_io", "load", "device_core", "proof_points"]
        assert all(r.proof == root.proof for r in recs if r.parent == root.index)
    assert [p for p, _ in TR.phases()[-2:]] == [r.proof for r in roots]
    for sink in sinks:
        assert {k: v for k, v in sink.items() if k.endswith("_device_s")} == \
            {f"{p}_device_s": 1e-3 * (i + 1) for i, p in enumerate(TR.PHASES)}
