"""The port's `.r1cs` reader and writer and its container writer against
the JAX package's: byte for byte on `examples/product/product.r1cs` and on
`synthetic_circuit(5)`, and a parse / write round trip."""

import os

import numpy as np
import pytest

from groth16_tpu.files import container as JC
from groth16_tpu.files import r1cs as JR
from groth16_tpu.models.circuits import synthetic_circuit as jax_synthetic

from groth16_tpu_torch import parse_r1cs, write_r1cs
from groth16_tpu_torch.files import container as TC
from groth16_tpu_torch.files.r1cs import r1cs_bytes
from groth16_tpu_torch.models.circuits import product_circuit, synthetic_circuit

PRODUCT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "examples", "product", "product.r1cs")


def _same_r1cs(a, b) -> bool:
    return (a.r == b.r and vars(a.cfg) == vars(b.cfg) and a.n_constr == b.n_constr
            and a.constraints == b.constraints
            and np.array_equal(np.asarray(a.wire_to_label, np.uint64),
                               np.asarray(b.wire_to_label, np.uint64)))


def test_product_r1cs_bytes_equal_jax_and_the_file():
    got = parse_r1cs(PRODUCT)
    want = JR.parse_r1cs(PRODUCT)
    assert _same_r1cs(got, want)
    assert r1cs_bytes(got) == JR.r1cs_bytes(want)
    with open(PRODUCT, "rb") as fh:
        assert r1cs_bytes(got) == fh.read()


@pytest.mark.parametrize("which", ["synthetic(5)", "product"])
def test_written_r1cs_equals_jax_and_round_trips(tmp_path, which):
    if which == "product":
        r1cs = product_circuit()[0]
        from groth16_tpu.models.circuits import product_circuit as jax_product
        jax_r1cs = jax_product()[0]
    else:
        r1cs, jax_r1cs = synthetic_circuit(5)[0], jax_synthetic(5)[0]
    path = tmp_path / "c.r1cs"
    write_r1cs(str(path), r1cs)
    raw = path.read_bytes()
    assert raw == JR.r1cs_bytes(jax_r1cs)
    back = parse_r1cs(str(path))
    assert _same_r1cs(back, JR.parse_r1cs(str(path)))
    assert back.constraints == [tuple([(i, v % back.r) for i, v in lc] for lc in c)
                                for c in r1cs.constraints]
    assert r1cs_bytes(back) == raw


def test_write_container_equals_jax(tmp_path):
    sections = [(1, b"\x01\x02\x03"), (2, b""), (2, bytes(range(256))), (7, b"z" * 1000)]
    TC.write_container(str(tmp_path / "t.bin"), "r1cs", 1, sections)
    JC.write_container(str(tmp_path / "j.bin"), "r1cs", 1, sections)
    raw = (tmp_path / "t.bin").read_bytes()
    assert raw == (tmp_path / "j.bin").read_bytes()
    assert TC.parse_container_bytes(raw, "r1cs", 1) == {
        1: [b"\x01\x02\x03"], 2: [b"", bytes(range(256))], 7: [b"z" * 1000]}
