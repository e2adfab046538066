"""Port file I/O (groth16_tpu_torch.files) vs the JAX package's parsers: the
committed examples/product artifacts parse to the same arrays, writers emit
the same bytes, and every malformed encoding of tests/test_wire_hardening.py
is rejected the same way."""

import os
import struct

import numpy as np
import pytest

from groth16_tpu.files import witness as JW, zkey as JZ
from groth16_tpu.files.container import container_bytes, parse_container_bytes
from groth16_tpu.ops.field import FP, FR
from groth16_tpu_torch.files import witness as TW, zkey as TZ
from groth16_tpu_torch.protocol.types import zkey_from_numpy
import torch

# The suite runs six worker processes on a few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "examples", "product")


def _raw(name):
    with open(os.path.join(EX, name), "rb") as f:
        return f.read()


def _same_zkey(a, b):
    assert a.header.__dict__.keys() == b.header.__dict__.keys()
    for k in ("curve", "p", "r", "nvars", "npubs", "domain_size", "log_domain_size"):
        assert getattr(a.header, k) == getattr(b.header, k)
    assert a.header.flavour.value == b.header.flavour.value
    for k in ("alpha1", "beta1", "beta2", "gamma2", "delta1", "delta2", "alpha_beta"):
        assert getattr(a.spec, k) == getattr(b.spec, k), k
    for nm in ("points_a1", "points_b1", "points_b2", "points_c1", "points_h1"):
        pa, pb = getattr(a.ppoints, nm), getattr(b.ppoints, nm)
        assert np.array_equal(pa.x, pb.x) and np.array_equal(pa.y, pb.y), nm
    ia, ib = a.vpoints.points_ic, b.vpoints.points_ic
    assert np.array_equal(ia.x, ib.x) and np.array_equal(ia.y, ib.y)
    for k in ("matrix", "row", "col", "coeff"):
        assert np.array_equal(getattr(a.coeffs, k), getattr(b.coeffs, k)), k


def test_example_artifacts_parse_identically(tmp_path):
    zt, zj = TZ.parse_zkey(os.path.join(EX, "product.zkey")), JZ.parse_zkey(os.path.join(EX, "product.zkey"))
    _same_zkey(zt, zj)
    _same_zkey(zt, zkey_from_numpy(zj))
    wt = TW.parse_witness(os.path.join(EX, "product.wtns"))
    wj = JW.parse_witness(os.path.join(EX, "product.wtns"))
    assert (wt.curve, wt.r, wt.nvars) == (wj.curve, wj.r, wj.nvars)
    assert np.array_equal(wt.values, wj.values)
    assert TZ.zkey_bytes(zt) == JZ.zkey_bytes(zj) == _raw("product.zkey")
    assert TW.witness_bytes(wt.values) == JW.witness_bytes(wj.values)


def _reserialize(raw, magic, version, patch=None, extra=None, order=None):
    secs = parse_container_bytes(raw, magic, version)
    items = [(sid, data) for sid in sorted(secs) for data in secs[sid]]
    if patch:
        items = [(sid, patch(sid, data)) for sid, data in items]
    if order is not None:
        items = [items[i] for i in order]
    if extra:
        items = items + extra
    return container_bytes(magic, version, items)


def _patch_point(sid, data):
    if sid != 5:
        return data
    x = int.from_bytes(data[:32], "little") + FP.modulus
    return x.to_bytes(32, "little") + data[32:]


def _patch_coeff(sid, data):
    if sid != 4:
        return data
    return data[:16] + FR.modulus.to_bytes(32, "little") + data[48:]


def _patch_alpha(sid, data):
    if sid != 2:
        return data
    off = 4 + 32 + 4 + 32 + 12 + 32
    y = int.from_bytes(data[off:off + 32], "little") + 1
    return data[:off] + y.to_bytes(32, "little") + data[off + 32:]


def _patch_domain(sid, data):
    if sid != 2:
        return data
    off = 4 + 32 + 4 + 32 + 8
    return data[:off] + struct.pack("<I", 12345) + data[off + 4:]


def _bad_zkeys():
    raw = _raw("product.zkey")
    dup = parse_container_bytes(raw, "zkey", 1)[5][0]
    return {
        "duplicate": _reserialize(raw, "zkey", 1, extra=[(5, dup)]),
        "truncated_body": raw[:-10],
        "truncated_header": raw[:8],
        "noncanonical_point": _reserialize(raw, "zkey", 1, patch=_patch_point),
        "noncanonical_coeff": _reserialize(raw, "zkey", 1, patch=_patch_coeff),
        "off_curve_spec": _reserialize(raw, "zkey", 1, patch=_patch_alpha),
        "bad_domain": _reserialize(raw, "zkey", 1, patch=_patch_domain),
    }


@pytest.mark.parametrize("case", sorted(_bad_zkeys()))
def test_malformed_zkey_rejected_like_jax(case, tmp_path):
    path = tmp_path / "bad.zkey"
    path.write_bytes(_bad_zkeys()[case])
    with pytest.raises(AssertionError) as jax_err:
        JZ.parse_zkey(str(path))
    with pytest.raises(AssertionError) as port_err:
        TZ.parse_zkey(str(path))
    assert str(port_err.value) == str(jax_err.value)


def test_out_of_order_sections_parse_identically(tmp_path):
    path = tmp_path / "rev.zkey"
    path.write_bytes(_reserialize(_raw("product.zkey"), "zkey", 1, order=list(reversed(range(9)))))
    _same_zkey(TZ.parse_zkey(str(path)), JZ.parse_zkey(str(path)))


def test_witness_above_r_rejected_like_jax(tmp_path):
    bad = _reserialize(_raw("product.wtns"), "wtns", 2,
                       patch=lambda sid, d: d if sid != 2 else FR.modulus.to_bytes(32, "little") + d[32:])
    path = tmp_path / "bad.wtns"
    path.write_bytes(bad)
    with pytest.raises(AssertionError) as jax_err:
        JW.parse_witness(str(path))
    with pytest.raises(AssertionError) as port_err:
        TW.parse_witness(str(path))
    assert str(port_err.value) == str(jax_err.value)
