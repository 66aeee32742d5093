"""The port's limb Montgomery multiply (K4) and its h(x) pipeline route,
held against the reference on the same seeded inputs (raw limbs, tolerance 0).

* The kernel's plain version, the port's `LimbField.mul`, == the
  reference's `mont_mul_pallas` in interpret mode (with a block that splits
  the lanes) == the CPU path of the port's wrapper `mont_mul`, on mock, Fp
  and Fr, with inputs up to 2p.
* The port's h(x) pipeline, whose coset product goes through `mont_mul`,
  == the reference's with BMT_PALLAS=1 (its K4 route) at exp=4.
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
from bellman_mpc_tpu_torch.groth16 import Bls12Engine
from bellman_mpc_tpu_torch.groth16 import prover as tpv
from bellman_mpc_tpu_torch.ops import kernel_lib
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
