"""The port's GLV-2 / GLS-4 layer against the reference, on the CPU, at
tolerance 0:

* the host decompositions, constants and endomorphisms (ops/glv.py's host
  half) equal the reference's on 200 seeded scalars and the edge scalars 0,
  1, r - 1, LAMBDA, LAMBDA +- 1 and z^j;
* the device decompositions and `digits_to_bits_msb` give the reference's
  raw outputs (jnp on the CPU) on a (24, 4, 16) batch of std digits, and
  their values are the host decompositions';
* `phi_extend_affine_tables` and `psi_extend_affine_tables_g2` give the
  reference's raw limbs on the same small tables (N = 4, c = 4, an identity
  base among them, so whole columns are the (0, 0) sentinel), and the
  extended points are phi / psi of the table points;
* the segmented RNS fold (`msm_table_affine_rns(seg_sizes=(8, 8, 4))`), with
  plain and with GLV signed digits, gives each segment's MSM of the host
  oracle; an identity base with nonzero scalars makes the fold gather the
  sentinel under a set sign.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bellman_mpc_tpu.fields.bls12_381 import fp as ref_fp
from bellman_mpc_tpu.ops import glv as ref_glv
from bellman_mpc_tpu.ops import msm as ref_msm
from bellman_mpc_tpu_torch.curves import rns_point as rpt
from bellman_mpc_tpu_torch.curves.device import g1_device, g2_device
from bellman_mpc_tpu_torch.curves.host import G1, G2
from bellman_mpc_tpu_torch.fields.bls12_381 import R, fp, fr
from bellman_mpc_tpu_torch.ops import glv
from bellman_mpc_tpu_torch.ops.fold_kernels import pad_rns_table
from bellman_mpc_tpu_torch.ops.msm import (
    digits_from_bits,
    msm_table_affine_rns,
    phi_extend_affine_tables,
    psi_extend_affine_tables_g2,
    signed_digits,
    tables_in_lazy_range,
    tables_to_rns,
    window_tables_affine,
)
from bellman_mpc_tpu_torch.parallel.batch_prover import bits_from_std, glv_signed_digits

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

EDGES = [0, 1, R - 1, glv.LAMBDA, glv.LAMBDA - 1, glv.LAMBDA + 1, glv.Z % R, glv.Z ** 2 % R,
         glv.Z ** 3 % R, (1 << 128) + 5]


def _scalars(n, seed):
    rng = random.Random(seed)
    return EDGES + [rng.randrange(R) for _ in range(n - len(EDGES))]


def _std_digits(ks, shape):
    """(24, *shape) int32 canonical 11-bit digits of the scalars ks."""
    arr = np.zeros((fr.L, len(ks)), np.int32)
    for j, k in enumerate(ks):
        for i in range(fr.L):
            arr[i, j] = (k >> (11 * i)) & 2047
    return arr.reshape((fr.L,) + shape)


def _to_int(col):
    return sum(int(d) << (11 * i) for i, d in enumerate(col))


def test_host_constants_match_reference():
    for name in ("LAMBDA", "GLV_S", "MU1", "MU2", "GLV_BITS", "GLS_BITS", "GLV_NBITS", "GLS_NBITS",
                 "_GLS_DET", "_GLS_MUS", "_GLS_SGN", "_GLS_C_DIGS", "_S_DIG", "_MAG_DIGS"):
        assert getattr(glv, name) == getattr(ref_glv, name), name
    assert glv._GLS_ADJ == ref_glv._GLS_ADJ
    assert glv._GLS_BASIS.tolist() == ref_glv._GLS_BASIS.tolist()
    assert glv._adjugate4([[2, 0, 0, 1], [0, 3, 0, 0], [0, 0, 5, 0], [1, 0, 0, 7]]) == \
        ref_glv._adjugate4([[2, 0, 0, 1], [0, 3, 0, 0], [0, 0, 5, 0], [1, 0, 0, 7]])
    assert glv.beta_g1() == ref_glv.beta_g1()
    assert glv.psi_constants() == ref_glv.psi_constants()


def test_host_decompositions_match_reference():
    for k in _scalars(200, 31):
        assert glv.decompose_glv2(k) == ref_glv.decompose_glv2(k), k
        assert glv.decompose_gls4(k) == ref_glv.decompose_gls4(k), k
        assert glv.gls4_eigen_check(k) and ref_glv.gls4_eigen_check(k)
        k1, k2 = glv.decompose_glv2(k)
        assert (k1 + k2 * glv.LAMBDA - k) % R == 0
        assert max(abs(k1), abs(k2)) < 1 << glv.GLV_BITS


def test_host_endomorphisms_match_reference():
    rng = random.Random(32)
    for _ in range(3):
        p = G1.mul(G1.generator, rng.randrange(1, R))
        q = G2.mul(G2.generator, rng.randrange(1, R))
        assert glv.phi_host(p) == ref_glv.phi_host(p) and G1.eq(glv.phi_host(p), G1.mul(p, glv.LAMBDA))
        assert glv.psi_host(q) == ref_glv.psi_host(q) and G2.eq(glv.psi_host(q), G2.mul(q, glv.Z % R))
    assert glv.phi_host(None) is None and glv.psi_host(None) is None


def test_device_decompositions_match_reference():
    ks = _scalars(64, 33)
    std = _std_digits(ks, (4, 16))
    got2 = glv.decompose_glv2_device(torch.from_numpy(std))
    want2 = jax.jit(ref_glv.decompose_glv2_device)(jnp.asarray(std))
    for g, w in zip(got2, want2):
        assert g.dtype == (torch.bool if g.dim() == 2 else torch.int32)
        assert np.array_equal(g.numpy(), np.asarray(w))
    got4 = glv.decompose_gls4_device(torch.from_numpy(std))
    want4 = jax.jit(ref_glv.decompose_gls4_device)(jnp.asarray(std))
    assert tuple(got4[1].shape) == (4, 7, 4, 16)
    for g, w in zip(got4, want4):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for nbits, mag in ((glv.GLV_NBITS, got2[1]), (glv.GLS_NBITS, got4[1][2])):
        bits = glv.digits_to_bits_msb(mag, nbits)
        assert np.array_equal(bits.numpy(), np.asarray(ref_glv.digits_to_bits_msb(jnp.asarray(mag.numpy()), nbits)))
    # the values: the host GLV split, and a GLS split of k within its bound
    neg1, mag1, neg2, mag2 = (t.reshape(t.shape[:-2] + (64,)) for t in got2)
    neg4, mag4 = (t.reshape(t.shape[:-2] + (64,)) for t in got4)
    for j, k in enumerate(ks):
        k1 = -_to_int(mag1[:, j]) if neg1[j] else _to_int(mag1[:, j])
        k2 = -_to_int(mag2[:, j]) if neg2[j] else _to_int(mag2[:, j])
        assert (k1, k2) == glv.decompose_glv2(k), k
        kis = [-_to_int(mag4[t, :, j]) if neg4[t, j] else _to_int(mag4[t, :, j]) for t in range(4)]
        assert max(abs(x) for x in kis) < 1 << glv.GLS_NBITS
        assert (sum(x * glv.Z ** t for t, x in enumerate(kis)) - k) % R == 0


@pytest.fixture(scope="module")
def small_tables():
    """Signed affine limb tables of 4 bases, c = 4, at the decomposed
    scalars' widths (G1 130 bits, G2 66 bits); base 2 is the identity."""
    rng = random.Random(34)
    out = {}
    for name, grp, host, nbits in (("g1", g1_device, G1, glv.GLV_NBITS), ("g2", g2_device, G2, glv.GLS_NBITS)):
        pts = [host.mul(host.generator, rng.randrange(1, R)) for _ in range(4)]
        pts[2] = None
        out[name] = (pts, window_tables_affine(grp.ops, grp.encode_points(pts, "cpu"), 4, nbits))
    return out


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_table_extensions_match_reference(small_tables, group):
    pts, tab = small_tables[group]
    if group == "g1":
        got = phi_extend_affine_tables(fp, tab)
        want = ref_msm.phi_extend_affine_tables(ref_fp, tuple(jnp.asarray(t.numpy()) for t in tab))
        assert got[0].shape[-1] == 8
    else:
        got = psi_extend_affine_tables_g2(fp, tab)
        want = ref_msm.psi_extend_affine_tables_g2(ref_fp, tuple(jnp.asarray(t.numpy()) for t in tab))
        assert got[0].shape[-1] == 16
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert tables_in_lazy_range(fp, got)
    # the identity base's columns, in every block, stay the exact sentinel
    n = len(pts)
    for blk in range(got[0].shape[-1] // n):
        assert all(int(t[..., blk * n + 2].abs().max()) == 0 for t in got)
    # block m holds endo^m of the table points: check window 1, bucket 3
    grp, host, endo = ((g1_device, G1, glv.phi_host) if group == "g1" else
                       (g2_device, G2, glv.psi_host))
    x, y = (t.select(-3, 1).select(-2, 3) for t in got)  # (L, [2,] blocks * n)
    z = grp.ops.one(tuple(x.shape[1 if group == "g1" else 2:]), "cpu")
    dec = grp.decode_points((x, y, z))
    base = [host.mul(p, 3 << 4) if p is not None else None for p in pts]
    want_pts = []
    for blk in range(len(dec) // n):
        want_pts += base
        base = [endo(p) for p in base]
    assert [d for d, w in zip(dec, want_pts) if w is not None] == [w for w in want_pts if w is not None]


@pytest.mark.parametrize("use_glv", [False, True], ids=["plain", "glv"])
def test_segmented_fold_matches_host(use_glv):
    """Three G1 MSMs of 8, 8 and 4 bases as one RNS fold over concatenated
    tables (B = 2, c = 4), each segment's point the host MSM."""
    rng = random.Random(35 + use_glv)
    sizes = (8, 8, 4)
    B, c = 2, 4
    rops, f = rpt.rns_g1_ops(), rpt.default_rns_field()
    bases, scal, tabs = [], [], []
    for s, n in enumerate(sizes):
        pts = [G1.mul(G1.generator, rng.randrange(1, R)) for _ in range(n)]
        pts[1] = None  # an identity base with nonzero scalars
        ks = [[rng.randrange(R) for _ in range(n)] for _ in range(B)]
        ks[0][3] = 0
        ks[1][0] = R - 1
        bases.append(pts)
        scal.append(ks)
        tab = window_tables_affine(g1_device.ops, g1_device.encode_points(pts, "cpu"), c,
                                   glv.GLV_NBITS if use_glv else 255)
        if use_glv:
            tab = phi_extend_affine_tables(fp, tab)
        rtab, bound = tables_to_rns(rops, fp, tab)
        tabs.append(rtab)
    merged = pad_rns_table(f, tuple(torch.cat([t[k] for t in tabs], dim=-1) for k in range(2)))
    std = torch.cat([torch.from_numpy(_std_digits([k for row in ks for k in row], (B, len(ks[0]))))
                     for ks in scal], dim=-1)  # (24, B, sum(sizes))
    if use_glv:
        sd = glv_signed_digits(std, c, logical_sizes=sizes)
        seg = tuple(2 * n for n in sizes)
        assert bool((sd < 0).any())
    else:
        sd = signed_digits(digits_from_bits(bits_from_std(fr, std), c), c)
        seg = sizes
    pts = msm_table_affine_rns(rops, fp, merged, sd, bound, seg_sizes=seg)  # (L, B, 3)
    assert tuple(pts[0].shape) == (fp.L, B, 3)
    got = g1_device.decode_points(tuple(x.reshape(fp.L, -1) for x in pts))
    want = [G1.msm(bases[s], scal[s][b]) for b in range(B) for s in range(len(sizes))]
    assert got == want
