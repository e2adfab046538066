"""The harness finds a cell's configuration, generator, traffic mix and
metrics by the names in BENCHMARK.json, and a new one of each is a new
file and a new entry, with no edit to a file already there."""

import hashlib
import json
import os
import shutil

from proofbench.harness import plan as PL

ROOT = PL.ROOT


def test_resolves_both_cells():
    a = PL.resolve("num2bits16.stream")
    assert a.chips == 1 and a.config["generator"] == "num2bits" and a.config["copies"] == 1985
    assert a.traffic["witness_pool"] == 8
    assert [m.name for m in a.end_to_end] == ["proofs_per_s", "latency_p95_ms",
                                              "peak_device_gib", "setup_s"]
    b = PL.resolve("sqchain20.stream")
    assert b.config["generator"] == "sqchain" and b.traffic["witness_pool"] == 2
    assert "latency_p95_ms" not in [m.name for m in b.end_to_end]
    assert [m.name for m in a.per_layer] == [m.name for m in b.per_layer]
    assert {m.layer for m in a.per_layer} >= {"Device", "Entry", "SpMV", "Quotient"}
    assert all(callable(m.read) for m in a.end_to_end + a.per_layer)


def test_benchmark_names_and_files():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and all(PL.NAME.match(n) for n in names)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert m["unit"] != "%" or m["name"].endswith(("_roofline", "_mfu", "_pct"))


def _digest(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_cell_config_mix_and_metric_are_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "proofbench"), tmp_path / "proofbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "proofbench")
    pb = tmp_path / "proofbench"
    (pb / "circuits" / "dummygen.py").write_text(
        "from proofbench.circuits.circuit import Circuit\n"
        "def build(cfg):\n    return ('dummy', cfg['size'])\n"
        "def witness(circuit, cfg, rng):\n    return [1]\n")
    (pb / "configs" / "dummy7.json").write_text(json.dumps(
        {"name": "dummy7", "source": "https://example.org/dummy", "generator": "dummygen",
         "size": 7, "flavour": "snarkjs", "reduced": []}))
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "witness_pool": 3, "traced_proofs": 1}))
    (pb / "layers" / "dummy.thing_ms.py").write_text("def read(ctx):\n    return 42.0\n")
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dummy7", "source": "https://example.org/dummy",
                             "file": "proofbench/configs/dummy7.json", "reduced": [],
                             "why": "a dummy"})
    bench["workloads"].append({"name": "dummy7.mix", "config": "dummy7", "traffic": "dummy_mix",
                               "chips": 1, "why": "a dummy"})
    bench["per_layer"].append({"name": "dummy.thing_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "Dummy",
                               "moves": "proofs_per_s", "workloads": ["dummy7.mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    p = PL.resolve("dummy7.mix", root=str(tmp_path))
    assert p.generator.build(p.config) == ("dummy", 7)
    assert p.traffic["witness_pool"] == 3
    assert [m.name for m in p.per_layer] == ["dummy.thing_ms"]
    assert p.per_layer[0].read(None) == 42.0
    assert [m.name for m in p.end_to_end] == ["proofs_per_s", "peak_device_gib", "setup_s"]
    after = _digest(tmp_path / "proofbench")
    assert all(after[k] == v for k, v in before.items())        # nothing there was edited
    # the real cells still resolve in the copy as they did
    assert [m.name for m in PL.resolve("num2bits16.stream", root=str(tmp_path)).per_layer] == \
        [m.name for m in PL.resolve("num2bits16.stream").per_layer]
