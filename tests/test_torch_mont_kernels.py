"""The port's limb Montgomery multiply (K4) and its h(x) pipeline route,
held against the reference on the same seeded inputs (raw limbs, tolerance 0).

* The kernel's plain version, the port's `LimbField.mul`, == the
  reference's `mont_mul_pallas` in interpret mode (with a block that splits
  the lanes) == the CPU path of the port's wrapper `mont_mul`, on mock, Fp
  and Fr, with inputs up to 2p.
* The port's h(x) pipeline, whose coset product goes through `mont_mul`,
  == the reference's with BMT_PALLAS=1 (its K4 route) at exp=4.
* The closed form the CUDA kernel's 32-bit-word design rests on: the plain
  version and the reference's `field.mul` both give the canonical digits of
  (a b + M p) / R, M = -a b p^-1 mod R in [0, R), computed with Python ints,
  on edge and seeded random operands of mock, Fr and Fp.
* The kernel's input contract (canonical digits, values below 2p) holds at
  every call site that reaches it, the h(x) pipeline and G1/G2 decode, and
  the kernel reads each of their operands in place.
* On the CPU, `LimbField.mul` and everything built on it launch no kernel.
* The kernel library rebuilds when a source is newer than it; the port's
  native C source is the reference's byte for byte; the engine defaults to
  the card.
"""

import os
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from bellman_mpc_tpu.fields.bls12_381 import fp as rfp
from bellman_mpc_tpu.fields.bls12_381 import fr as rfr
from bellman_mpc_tpu.fields.bls12_381 import fr_host
from bellman_mpc_tpu.fields.mock import mock as rmock
from bellman_mpc_tpu.groth16 import prover as rpv
from bellman_mpc_tpu.ops.pallas_kernels import mont_mul_pallas
from bellman_mpc_tpu_torch.fields.bls12_381 import fp as tfp
from bellman_mpc_tpu_torch.fields.bls12_381 import fr as tfr
from bellman_mpc_tpu_torch.fields.mock import mock as tmock
from bellman_mpc_tpu_torch.curves import device as tdev
from bellman_mpc_tpu_torch.curves.host import G1 as HG1
from bellman_mpc_tpu_torch.curves.host import G2 as HG2
from bellman_mpc_tpu_torch.fields.limb import LimbField
from bellman_mpc_tpu_torch.groth16 import Bls12Engine
from bellman_mpc_tpu_torch.groth16 import prover as tpv
from bellman_mpc_tpu_torch.ops import kernel_lib, mont_kernels
from bellman_mpc_tpu_torch.ops.mont_kernels import mont_mul

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

REPO = Path(__file__).resolve().parents[1]
FIELDS = [(rmock, tmock), (rfp, tfp), (rfr, tfr)]


def _lazy_limbs(rng, f, n):
    """(L, n) int32 canonical digits of values in [0, 2p), both ends included."""
    vals = [rng.randrange(2 * f.p) for _ in range(n - 2)] + [2 * f.p - 1, 0]
    return np.asarray([[(v >> (11 * i)) & 2047 for v in vals] for i in range(f.L)], np.int32)


@pytest.mark.parametrize("ref,port", FIELDS, ids=["mock", "Fp", "Fr"])
def test_plain_matches_reference_kernel(ref, port):
    rng = random.Random(port.L)
    a, b = _lazy_limbs(rng, port, 256), _lazy_limbs(rng, port, 256)
    want = np.asarray(mont_mul_pallas(ref, a, b, block=128))  # two blocks, interpret mode
    got = port.mul(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(want, got.numpy())
    assert torch.equal(got, mont_mul(port, torch.from_numpy(a), torch.from_numpy(b)))


def _closed_form_limbs(f, va, vb):
    """Canonical digits of (a b + M p) / R with M = -a b p^-1 mod R in [0, R)."""
    pinv = pow(f.p, -1, f.R)
    out = []
    for a, b in zip(va, vb):
        t = a * b
        v = (t + (-t * pinv) % f.R * f.p) // f.R
        assert (t + (-t * pinv) % f.R * f.p) % f.R == 0 and v < 2 * f.p
        out.append([(v >> (11 * i)) & 2047 for i in range(f.L)])
    return np.asarray(out, np.int32).T


@pytest.mark.parametrize("ref,port", FIELDS, ids=["mock", "Fp", "Fr"])
def test_plain_and_reference_equal_the_closed_form(ref, port):
    rng = random.Random(port.L + 7)
    p = port.p
    edges = [0, 1, p - 1, p, 2 * p - 1]
    va = [x for x in edges for _ in edges] + [rng.randrange(2 * p) for _ in range(39)]
    vb = [y for _ in edges for y in edges] + [rng.randrange(2 * p) for _ in range(39)]
    a, b = (np.asarray([[(v >> (11 * i)) & 2047 for v in vs] for i in range(port.L)], np.int32)
            for vs in (va, vb))
    want = _closed_form_limbs(port, va, vb)
    assert np.array_equal(port.mul_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
    assert np.array_equal(np.asarray(ref.mul(a, b)), want)


def _checked_plain(monkeypatch):
    """Replace LimbField.mul_plain by a version that asserts K4's input
    contract on each operand: canonical 11-bit digits, value below 2p, and
    lanes the kernel reads in place (no copy)."""
    calls = []
    plain = LimbField.mul_plain

    def checked(self, a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        for t in (a, b):
            assert bool(((t >= 0) & (t <= 2047)).all()), "a digit is not canonical"
            _, borrow = self._sub_flat(t, self._2p(t.device))
            assert bool(borrow.all()), "a value is not below 2p"
            assert mont_kernels.lane_map(t, shape) is not None, "the kernel would need a copy"
        calls.append(self.L)
        return plain(self, a, b)

    monkeypatch.setattr(LimbField, "mul_plain", checked)
    return calls


def _projective(group, hostg, rng, n):
    """n projective points with Z != 1: sums of two encoded multiples of the
    generator through the device's complete addition."""
    pts = [[hostg.mul(hostg.generator, rng.randrange(1, 1 << 32)) for _ in range(n)] for _ in range(2)]
    p, q = (group.encode_points(x, "cpu") for x in pts)
    return tdev.point_add(group.ops, p, q), [hostg.add(x, y) for x, y in zip(*pts)]


@pytest.mark.parametrize("site", ["h_pipeline", "decode_g1", "decode_g2"])
def test_kernel_contract_holds_at_call_sites(monkeypatch, site):
    rng = random.Random(5)
    if site == "h_pipeline":
        exp, B = 5, 2
        abc = [tfr.encode([rng.randrange(fr_host.p) for _ in range(B << exp)]).reshape(tfr.L, B, 1 << exp)
               for _ in range(3)]
        calls = _checked_plain(monkeypatch)
        tpv._h_pipeline(tfr, fr_host, exp)(*abc)
        assert calls.count(tfr.L) == 15 * exp + 10  # every multiply of the pipeline
    else:
        group, hostg = (tdev.g1_device, HG1) if site == "decode_g1" else (tdev.g2_device, HG2)
        pt, want = _projective(group, hostg, rng, 2)
        calls = _checked_plain(monkeypatch)
        assert group.decode_points(pt) == want
        assert len(calls) > 600 and set(calls) == {tfp.L}  # the Fermat inversion and more


def test_cpu_multiplies_launch_no_kernel(monkeypatch):
    def no_kernel():
        raise AssertionError("a CPU multiply reached the kernel library")

    monkeypatch.setattr(mont_kernels, "load", no_kernel)
    before = dict(kernel_lib.launch_counts), dict(kernel_lib.plain_counts)
    rng = random.Random(3)
    x = tfr.encode([rng.randrange(fr_host.p) for _ in range(6)])
    y = tfr.inv(tfr.square(tfr.mul_const(tfr.mul(x, tfr.to_mont(x)), 5)))
    assert tfr.decode(tfr.mul(y, tfr.from_mont(x))) is not None
    assert (dict(kernel_lib.launch_counts), dict(kernel_lib.plain_counts)) == before


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros((tfr.L, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        mont_mul(tfr, x, x[:, :4])
    with pytest.raises(ValueError):
        mont_mul(tfp, x, x)


def test_h_pipeline_kernel_route_matches_reference(monkeypatch):
    exp = 4
    rng = random.Random(11)
    coeffs = [[rng.randrange(fr_host.p) for _ in range(1 << exp)] for _ in range(3)]
    monkeypatch.setenv("BMT_PALLAS", "1")
    rpv._h_pipeline.cache_clear()
    try:
        want = np.asarray(rpv._h_pipeline(rfr, fr_host, exp)(*(rfr.encode(c) for c in coeffs)))
    finally:
        rpv._h_pipeline.cache_clear()  # do not leak the flagged reference pipeline
    before = kernel_lib.launch_counts["mont_mul"]
    got = tpv._h_pipeline(tfr, fr_host, exp)(*(tfr.encode(c) for c in coeffs))
    assert np.array_equal(want, got.numpy())
    assert kernel_lib.launch_counts["mont_mul"] == before  # CPU tensors launch nothing


def test_kernel_library_rebuilds_when_a_source_is_newer(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    so = tmp_path / "libbmt_fold.so"
    monkeypatch.setattr(kernel_lib, "_CSRC", csrc)
    monkeypatch.setattr(kernel_lib, "_SO", so)
    (csrc / "a.cu").write_text("")
    assert kernel_lib._stale()  # no library yet
    so.write_bytes(b"")
    os.utime(csrc / "a.cu", (1000, 1000))
    os.utime(so, (2000, 2000))
    assert not kernel_lib._stale()
    (csrc / "b.cu").write_text("")  # a source added after the build
    os.utime(csrc / "b.cu", (3000, 3000))
    assert kernel_lib._stale()


def test_native_source_is_the_reference_copy():
    port = (REPO / "bellman_mpc_tpu_torch" / "native" / "bmt_native.c").read_bytes()
    assert port == (REPO / "bellman_mpc_tpu" / "native" / "bmt_native.c").read_bytes()


def test_engine_defaults_to_the_card():
    engine = Bls12Engine()
    assert engine.device == torch.device("cuda", 0)
    assert engine.g1.device.type == engine.g2.device.type == "cuda"
    assert Bls12Engine("cpu").device.type == "cpu"
