"""The CUDA kernels against their plain PyTorch versions, on the card, and
the port's device paths against the CPU or the host oracle: the pairing,
the ceremony, the group iNTT, the limb MSMs and the comb, every
BatchProver strategy against the rns proofs, the lazy columns' kernels (K5,
K6) in the point operations and the rns prover, the NTT bench's launches,
and the (2, 2) logical mesh of one card against the table strategy.

Imports neither jax nor the reference, so it runs on the GPU machine:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

Every test here needs a CUDA card and skips without one.  Lane counts that
are not a multiple of the RNS kernels' 8-lane tile or the limb multiply's
64-thread block exercise the ragged edge; "wave+1" is one lane past a full
wave of the kernel's own persistent blocks (K1, K2: 8-lane tiles, K3: units
of 6 tiles), so one block takes a second, ragged unit, or for K4, K5 and
K6 one lane past the blocks the card holds at once.
"""

import random
from fractions import Fraction

import pytest
import torch

from bellman_mpc_tpu_torch.curves import pairing_host as ph
from bellman_mpc_tpu_torch.curves import rns_point as rpt
from bellman_mpc_tpu_torch.curves.host import G1, G2
from bellman_mpc_tpu_torch.fields.bls12_381 import R, fp, fr
from bellman_mpc_tpu_torch.fields.mock import mock
from bellman_mpc_tpu_torch.ops import fold_kernels as fk
from bellman_mpc_tpu_torch.ops import kernel_lib
from bellman_mpc_tpu_torch.fields.limb import LazyCols, LimbField, _reduce_plan
from bellman_mpc_tpu_torch.ops import mont_kernels as mk
from bellman_mpc_tpu_torch.ops import pairing
from bellman_mpc_tpu_torch.ops.mont_kernels import mont_mul

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

F = rpt.default_rns_field()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU machine")
    return torch.device("cuda", 0)


def _tile(rng, n, dev, zero_cols=()):
    t = fk.rns_pad_rows(F, F.encode([rng.randrange(F.p) for _ in range(n)], device=dev).res)
    t[:, list(zero_cols)] = 0
    return t.contiguous()


def _lanes(lanes, wave=fk.fold_wave_lanes):
    return wave() + 1 if lanes == "wave+1" else lanes


TC_LANES = [13, 256, 257, "wave+1"]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", TC_LANES)
def test_k3_matches_plain(dev, lanes):
    lanes = _lanes(lanes, fk.rns_mul_wave_lanes)
    rng = random.Random(lanes)
    x, y = _tile(rng, lanes, dev, [0, lanes - 1]), _tile(rng, lanes, dev)
    before = kernel_lib.launch_counts["rns_mul_many"]
    got = fk.rns_mul_many(F, fk.rns_unpad_rows(F, x), fk.rns_unpad_rows(F, y))
    assert torch.equal(fk.rns_pad_rows(F, got), fk.rns_mul_block_plain(F, x, y))
    assert kernel_lib.launch_counts["rns_mul_many"] == before + 1


def _k1_inputs(rng, lanes, dev):
    q = (_tile(rng, lanes, dev, [0, 5, lanes - 1]), _tile(rng, lanes, dev, [0, 7, lanes - 1]))
    sg = torch.tensor([rng.randrange(2) == 1 for _ in range(lanes)], device=dev)
    return q, sg


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", TC_LANES)
def test_k1_matches_plain(dev, lanes):
    lanes = _lanes(lanes)
    rng = random.Random(lanes + 1)
    acc = tuple(_tile(rng, lanes, dev) for _ in range(3))
    q, sg = _k1_inputs(rng, lanes, dev)
    got = fk.rns_fold_window(F, 12, acc, q, sg, Fraction(37), Fraction(fk.G1_CAP))
    want = fk.fold_window_g1_plain(F, 12, acc, q[0], q[1], sg.to(torch.int32), 37, fk.G1_CAP)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fk.launch_counts["rns_fold_window"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [257, "wave+1"])
def test_k1_chained_windows(dev, lanes):
    """Three windows, each kernel output the next window's accumulator."""
    lanes = _lanes(lanes)
    rng = random.Random(lanes + 3)
    acc = want = tuple(_tile(rng, lanes, dev) for _ in range(3))
    for _ in range(3):
        q, sg = _k1_inputs(rng, lanes, dev)
        acc = fk.rns_fold_window(F, 12, acc, q, sg, Fraction(37), Fraction(fk.G1_CAP))
        want = fk.fold_window_g1_plain(F, 12, want, q[0], q[1], sg.to(torch.int32), 37, fk.G1_CAP)
        assert all(torch.equal(g, w) for g, w in zip(acc, want))


def _fp2_tile(rng, lanes, dev, zero_cols=(), zero_c1=()):
    """(80, 2, lanes): both components zero at zero_cols, component 1 alone
    at zero_c1."""
    c1 = list(zero_cols) + list(zero_c1)
    return torch.stack([_tile(rng, lanes, dev, zero_cols), _tile(rng, lanes, dev, c1)], dim=1)


def _k2_inputs(rng, lanes, dev):
    """Gathered points with the (0, 0) sentinel at the first and last lanes,
    and lanes that are zero only in part, which are not the sentinel: lane 4
    with x1 = y1 = 0 (x0, y0 nonzero), lane 5 with x = 0."""
    qx = _fp2_tile(rng, lanes, dev, [0, 5, lanes - 1], [4])
    qy = _fp2_tile(rng, lanes, dev, [0, lanes - 1], [4])
    sg = torch.tensor([rng.randrange(2) == 1 for _ in range(lanes)], device=dev)
    return (qx, qy), sg


def _k2_plain(acc, q, sg):
    return fk.fold_window_g2_plain_stacked(F, 12, acc, q, sg, 37, fk.G2_CAP)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", TC_LANES)
def test_k2_matches_plain(dev, lanes):
    lanes = _lanes(lanes, fk.fold_g2_wave_lanes)
    rng = random.Random(lanes + 2)
    acc = tuple(_fp2_tile(rng, lanes, dev) for _ in range(3))
    q, sg = _k2_inputs(rng, lanes, dev)
    before = kernel_lib.launch_counts["rns_fold_window_g2"]
    got = fk.rns_fold_window_g2(F, 12, acc, q, sg, Fraction(37), Fraction(fk.G2_CAP))
    assert all(torch.equal(g, w) for g, w in zip(got, _k2_plain(acc, q, sg)))
    assert kernel_lib.launch_counts["rns_fold_window_g2"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [257, "wave+1"])
def test_k2_chained_windows(dev, lanes):
    """Three windows, each kernel output the next window's accumulator."""
    lanes = _lanes(lanes, fk.fold_g2_wave_lanes)
    rng = random.Random(lanes + 4)
    acc = want = tuple(_fp2_tile(rng, lanes, dev) for _ in range(3))
    for _ in range(3):
        q, sg = _k2_inputs(rng, lanes, dev)
        acc = fk.rns_fold_window_g2(F, 12, acc, q, sg, Fraction(37), Fraction(fk.G2_CAP))
        want = _k2_plain(want, q, sg)
        assert all(torch.equal(g, w) for g, w in zip(acc, want))


@pytest.mark.cuda
def test_wrappers_reject_bad_tiles(dev):
    x = torch.zeros((fk.PAD_C, 8), dtype=torch.int32, device=dev)
    sg = torch.zeros(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):  # int64 tiles
        fk.rns_fold_window(F, 12, (x.long(),) * 3, (x, x), sg, Fraction(37), Fraction(128))
    x2 = torch.zeros((fk.PAD_C, 8, 2), dtype=torch.int32, device=dev).transpose(1, 2)
    with pytest.raises(ValueError):  # (80, 2, lanes) views K2 would have to copy
        fk.rns_fold_window_g2(F, 12, (x2,) * 3, (x2,) * 2, sg, Fraction(37), Fraction(256))


def _limbs(f, vals, dev):
    return torch.tensor([[(v >> (11 * i)) & 2047 for v in vals] for i in range(f.L)],
                        dtype=torch.int32, device=dev)


def _k4_lanes(f, lanes):
    return mk.wave_lanes(f.L) + 1 if lanes == "wave+1" else lanes


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 13, 257, "wave+1"])
@pytest.mark.parametrize("f", [mock, fp, fr], ids=["mock", "Fp", "Fr"])
def test_k4_matches_plain(dev, f, lanes):
    """K4 and the dispatched LimbField.mul against the plain version, with
    the edge operands 0, 1, p-1, p, 2p-1 in every pairing at the first lanes."""
    lanes = _k4_lanes(f, lanes)
    rng = random.Random(f.L * 1000 + lanes)
    edges = [0, 1, f.p - 1, f.p, 2 * f.p - 1]
    pairs = [(x, y) for x in edges for y in edges][:lanes]
    va = [x for x, _ in pairs] + [2 * f.p - 1 - rng.randrange(1 << 8) if i % 2 else rng.randrange(2 * f.p)
                                  for i in range(lanes - len(pairs))]
    vb = [y for _, y in pairs] + [rng.randrange(2 * f.p) for _ in range(lanes - len(pairs))]
    a, b = _limbs(f, va, dev), _limbs(f, vb, dev)
    want = f.mul_plain(a, b)
    before = kernel_lib.launch_counts["mont_mul"]
    got = mont_mul(f, a, b)
    via_mul = f.mul(a, b)
    torch.cuda.synchronize()
    assert kernel_lib.launch_counts["mont_mul"] == before + 2
    assert torch.equal(got, want) and torch.equal(via_mul, want)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [fp, fr], ids=["Fp", "Fr"])
def test_k4_strided_and_broadcast_operands(dev, f):
    """The call sites' operands, read in place: an NTT stage's upper half
    against its (L, 1, 1, half) twiddles, a mul_const broadcast, the
    components of an (L, 2, B) Fp2 stack, and a view of three lane levels
    (which the wrapper copies)."""
    rng = random.Random(f.L)
    x = _limbs(f, [rng.randrange(2 * f.p) for _ in range(16 * 64)], dev).reshape(f.L, 16, 64)
    for s in (1, 3, 6):
        m, half = 1 << s, 1 << (s - 1)
        v = x.reshape(f.L, 16, 64 // m, m)[..., half:]
        tw = _limbs(f, [rng.randrange(f.p) for _ in range(half)], dev).reshape(f.L, 1, 1, half)
        assert torch.equal(f.mul(v, tw), f.mul_plain(v, tw))
        assert torch.equal(f.mul(tw, v), f.mul_plain(v, tw))
    assert torch.equal(f.mul_const(x, 12345), f.mul_plain(x, f.limbs_const(12345 * f.R % f.p, x)))
    st = x[:, :2].reshape(f.L, 2, 64)
    assert torch.equal(f.mul(st[:, 0], st[:, 1]), f.mul_plain(st[:, 0], st[:, 1]))
    z = x.reshape(f.L, 4, 4, 64)[:, :, 1:, 1:]
    assert mk.lane_map(z, z.shape) is None
    assert torch.equal(f.mul(z, f.mont_one((1, 1, 1), dev)), f.mul_plain(z, f.mont_one((1, 1, 1), dev)))


@pytest.mark.cuda
def test_k4_rejects_strided_input(dev):
    """Strided views are now read in place (previous test); what the wrapper
    still rejects: another dtype, mixed devices, an L without a kernel, and
    shapes that do not broadcast."""
    x = torch.zeros((fr.L, 16), dtype=torch.int32, device=dev)
    assert torch.equal(mont_mul(fr, x[:, ::2], x[:, ::2]), torch.zeros_like(x[:, ::2]))
    with pytest.raises(ValueError):
        mont_mul(fr, x.long(), x.long())
    with pytest.raises(ValueError):
        mont_mul(fr, x, x.cpu())
    with pytest.raises(ValueError):
        mont_mul(fr, x, x[:, :4])
    f5 = LimbField((1 << 50) - 27)  # L = 6: no kernel
    y = torch.zeros((f5.L, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        mont_mul(f5, y, y)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 9])
def test_device_pairing_matches_host_oracle(dev, n):
    """pairing_batch on the card at n = 3 (bucket 8) and a ragged n = 9
    (bucket 32), lane 1's G1 point the identity, equals the host oracle;
    every limb multiply launched K4 and none ran the plain version."""
    rng = random.Random(n)
    g1s = [G1.mul(G1.generator, rng.randrange(1, R)) for _ in range(n)]
    g2s = [G2.mul(G2.generator, rng.randrange(1, R)) for _ in range(n)]
    g1s[1] = None
    kernel_lib.reset_launch_counts()
    got = pairing.pairing_batch(g1s, g2s, device=dev)
    assert kernel_lib.plain_counts["mont_mul"] == 0 and kernel_lib.launch_counts["mont_mul"] > 0
    assert got == [ph.pairing(p, q) for p, q in zip(g1s, g2s)]


@pytest.mark.cuda
def test_device_pairing_equations(dev):
    """pairing_product_is_one and pairing_eq_batch on the card give the
    known answers, with no plain multiply."""
    a, b = G1.mul(G1.generator, 9), G2.mul(G2.generator, 13)
    kernel_lib.reset_launch_counts()
    for k, want in ((117, True), (116, False)):
        neg = G1.neg(G1.mul(G1.generator, k))
        assert pairing.pairing_product_is_one([a, neg], [b, G2.generator], device=dev) is want
    a7, b11 = G1.mul(G1.generator, 7), G2.mul(G2.generator, 11)
    eqs = pairing.pairing_eq_batch(
        [a7, a7, None], [b11, b11, b11],
        [G1.mul(G1.generator, 77), G1.mul(G1.generator, 5), None], [G2.generator, G2.generator, b11],
        device=dev)
    assert eqs.tolist() == [True, False, True]
    assert kernel_lib.plain_counts["mont_mul"] == 0


@pytest.mark.cuda
def test_anddemo_lagrange_ceremony_equals_generator(dev):
    """The canned ceremony on AndDemo (groth16/mpc.generate_parameters_mpc,
    Lagrange basis) on the card gives generate_parameters' CRS under the
    deterministic trapdoor byte for byte, with no plain multiply and no fold
    kernel."""
    from bellman_mpc_tpu_torch.groth16 import (
        DETERMINISTIC_TRAPDOOR,
        Bls12Engine,
        generate_parameters,
        params_to_bytes,
    )
    from bellman_mpc_tpu_torch.groth16.mpc import generate_parameters_mpc
    from bellman_mpc_tpu_torch.models import AndDemo

    eng = Bls12Engine(dev)
    t = DETERMINISTIC_TRAPDOOR
    direct = generate_parameters(eng, AndDemo(None, None), G1.generator, G2.generator,
                                 t["alpha"], t["beta"], t["gamma"], t["delta"], t["tau"])
    kernel_lib.reset_launch_counts()
    ceremony = generate_parameters_mpc(eng, AndDemo(None, None), basis="lagrange")
    assert kernel_lib.plain_counts["mont_mul"] == 0 and kernel_lib.launch_counts["mont_mul"] > 0
    assert kernel_lib.launch_counts["rns_fold_window"] == kernel_lib.launch_counts["rns_fold_window_g2"] == 0
    assert params_to_bytes(ceremony) == params_to_bytes(direct)


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_device_group_intt_matches_host_butterflies(dev, group):
    """The device group iNTT (_BlsGroup.intt above 4 points) of 16 points
    on the card equals GroupAPI.intt's host butterflies."""
    from bellman_mpc_tpu_torch.groth16 import Bls12Engine, GroupAPI

    eng = Bls12Engine(dev)
    grp = getattr(eng, group)
    rng = random.Random(16)
    pts = [grp.mul(grp.generator(), rng.randrange(1, R)) for _ in range(16)]
    kernel_lib.reset_launch_counts()
    got = grp.intt(pts, eng.fr_host)
    assert kernel_lib.plain_counts["mont_mul"] == 0 and kernel_lib.launch_counts["mont_mul"] > 0
    assert got == GroupAPI.intt(grp, pts, eng.fr_host)


def _no_fold():
    return (kernel_lib.launch_counts["rns_fold_window"] == kernel_lib.launch_counts["rns_fold_window_g2"]
            == kernel_lib.launch_counts["rns_mul_many"] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,g2",
    [("pippenger", False), ("pippenger_batched", False), ("pippenger_batched", True),
     ("flatpip", False), ("table", False), ("table_affine", False), ("comb", False), ("comb", True)],
    ids=["pippenger", "pippenger_batched-G1", "pippenger_batched-G2", "flatpip", "table",
         "table_affine", "comb-G1", "comb-G2"],
)
def test_limb_msms_match_cpu(dev, kind, g2):
    """The limb MSMs and the comb (ops/msm.py) on the card give the same
    points as the same call on the CPU (n = 16, B = 2, c = 4; an identity
    base, duplicate digits), with no plain multiply and no fold kernel."""
    from bellman_mpc_tpu_torch.curves.device import g1_device, g2_device, scalars_to_bits
    from bellman_mpc_tpu_torch.ops import msm

    grp, hostg = (g2_device, G2) if g2 else (g1_device, G1)
    rng = random.Random(17)
    c = 4
    if kind == "comb":
        base = hostg.mul(hostg.generator, 999)
        exps = [0, 1, 2, R - 1] + [rng.randrange(R) for _ in range(4)]
        kernel_lib.reset_launch_counts()
        got = msm.batch_mul_comb_host(grp, base, exps, dev)
        assert kernel_lib.plain_counts["mont_mul"] == 0 and _no_fold()
        assert got == msm.batch_mul_comb_host(grp, base, exps, "cpu")
        return
    bases = [hostg.mul(hostg.generator, rng.randrange(2, 500)) for _ in range(16)]
    bases[3] = None
    scal = [[7] * 8 + [255] * 4 + [0, 1, R - 1, rng.randrange(R)], [rng.randrange(R) for _ in range(16)]]
    bits = torch.stack([scalars_to_bits(s, 255) for s in scal], dim=1)

    def run(device):
        ops = grp.ops
        pts = grp.encode_points(bases, device)
        digits = msm.digits_from_bits(bits.to(device), c)
        if kind == "pippenger":
            return tuple(x[..., None] for x in msm.msm_pippenger(ops, pts, digits[:, 0], c))
        if kind == "pippenger_batched":
            return msm.msm_pippenger_batched(ops, pts, digits, c)
        if kind == "flatpip":
            return msm.msm_flat_pippenger(ops, msm.shifted_bases(ops, pts, c), digits, c)
        if kind == "table":
            return msm.msm_table(ops, msm.window_tables(ops, pts, c), digits)
        return msm.msm_table_affine(ops, msm.window_tables_affine(ops, pts, c), msm.signed_digits(digits, c))

    kernel_lib.reset_launch_counts()
    out = run(dev)
    assert out[0].is_cuda
    got = grp.decode_points(tuple(x[..., 0] for x in out))
    assert kernel_lib.plain_counts["mont_mul"] == 0 and _no_fold()
    assert got == grp.decode_points(tuple(x[..., 0] for x in run("cpu")))


@pytest.fixture(scope="module")
def mimc8():
    """MiMC rounds=8 on the card: its CRS, two witnesses and the rns
    strategy's proofs of them ("auto" on a CUDA engine)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the GPU machine")
    from bellman_mpc_tpu_torch.groth16 import Bls12Engine, generate_random_parameters
    from bellman_mpc_tpu_torch.models import MiMCDemo, mimc_constants
    from bellman_mpc_tpu_torch.parallel import BatchProver

    eng = Bls12Engine("cuda:0")
    constants = mimc_constants(eng.fr_host, seed=9, rounds=8)
    params = generate_random_parameters(eng, MiMCDemo(constants))
    bp = BatchProver(eng, params, MiMCDemo(constants, 0, 0))
    assert bp.msm_strategy == "rns"
    rng = random.Random(18)
    circuits = [MiMCDemo(constants, rng.randrange(eng.fr_host.p), rng.randrange(eng.fr_host.p))
                for _ in range(2)]
    return eng, params, constants, circuits, bp.prove_batch(circuits)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,signed", [("ladder", "1"), ("table", "1"), ("table", "0"),
                                             ("pippenger", "1"), ("flatpip", "1")],
                         ids=["ladder", "table", "table-unsigned", "pippenger", "flatpip"])
def test_batch_prover_strategies_match_rns(mimc8, strategy, signed, monkeypatch):
    """Each limb strategy's BatchProver on the card (pippenger_c = 4, the
    signed tables at pick_table_c's width, the unsigned at 4) gives the rns
    strategy's proofs, with no plain multiply and no fold kernel."""
    from bellman_mpc_tpu_torch.models import MiMCDemo
    from bellman_mpc_tpu_torch.parallel import BatchProver

    eng, params, constants, circuits, want = mimc8
    monkeypatch.setenv("BMT_TABLE_SIGNED", signed)
    kernel_lib.reset_launch_counts()
    bp = BatchProver(eng, params, MiMCDemo(constants, 0, 0), msm_strategy=strategy, pippenger_c=4)
    assert bp.prove_batch(circuits) == want
    assert kernel_lib.plain_counts["mont_mul"] == 0 and kernel_lib.launch_counts["mont_mul"] > 0
    assert _no_fold()


# ------------------------------------------- the lazy columns (K5, K6)


def _lazy_lanes(kernel, f, lanes):
    return mk.wave_lanes(f.L, kernel) + 1 if lanes == "wave+1" else lanes


def _lazy_operands(f, rng, n, dev="cpu"):
    """(L, n) Montgomery digits of values below 2p; lane 0 at the digit bound
    `_dmax_lazy`, lane n - 1 the value 2p - 1."""
    vals = [rng.randrange(2 * f.p) for _ in range(n - 1)] + [2 * f.p - 1]
    t = _limbs(f, vals, "cpu")
    t[:, 0] = torch.tensor(f._dmax_lazy, dtype=torch.int32)
    return t.to(dev)


def _caller_columns(f, rng, n):
    """LazyCols at the bounds their callers make (on the CPU, plain path),
    each with its `wide`: a product of `_dmax_lazy` operands, one of digit
    sums (`ldsum`), the Karatsuba t2 - t0 - t1 with its `_sub_plan`
    offsets, 3 t0 + t1, an `lb3` scaling, a scaling to the int32 edge (a
    plan with folds before the REDC), point_add_mixed's wide sum with a
    lifted element, and a wide scaling (pR <= T < 3pR)."""
    a, b, c, d = (_lazy_operands(f, rng, n) for _ in range(4))
    dm = f._dmax_lazy
    d2 = tuple(2 * x for x in dm)
    t0, t1, t2 = f.lazy_mul_many([(a, b), (c, d), (a + c, b + d)], [(dm, dm), (dm, dm), (d2, d2)])
    value = lambda lc: sum(h << (11 * i) for i, h in enumerate(lc.hi))
    edge = t0.scale(min(((1 << 31) - 1) // max(t0.hi), (f.p * f.R - 1) // value(t0)))
    lifted = LazyCols(f, torch.cat([torch.zeros_like(c), c], dim=0), (0,) * f.L + dm)
    folded = t0.fold()
    return [(t0, False), (t2, False), (t2 - t0 - t1, False), (3 * t0 + t1, False),
            (t0.fold().scale(12) - t1, False), (edge, False), (t2 + lifted, True),
            (folded.scale((3 * f.p * f.R - 1) // value(folded)), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 13, 257, "wave+1"])
@pytest.mark.parametrize("f", [mock, fp, fr], ids=["mock", "Fp", "Fr"])
def test_k5_matches_plain(dev, f, lanes):
    """K5 and lazy_mul_many against the plain columns: three stacked
    products of lazy operands and of digit sums (2x the digit bound), and a
    broadcast operand read in place."""
    lanes = _lazy_lanes("lazy_cols", f, lanes)
    rng = random.Random(f.L * 1000 + lanes + 5)
    ops = [_lazy_operands(f, rng, lanes) for _ in range(4)]
    a = torch.stack([ops[0], ops[1], ops[0] + ops[2]], dim=1).to(dev)
    b = torch.stack([ops[1], ops[3], ops[1] + ops[3]], dim=1).to(dev)
    before = kernel_lib.launch_counts["lazy_cols"]
    got = (mk.lazy_cols(f, a, b), mk.lazy_cols(f, a, b[:, :1, :1]))
    prods = f.lazy_mul_many([(a[:, 0], b[:, 0]), (a[:, 1], b[:, 1])])
    torch.cuda.synchronize()
    assert kernel_lib.launch_counts["lazy_cols"] == before + 3
    assert torch.equal(got[0].cpu(), f.mul_cols(a.cpu(), b.cpu()))
    assert torch.equal(got[1].cpu(), f.mul_cols(a.cpu(), b[:, :1, :1].cpu()))
    assert all(torch.equal(lc.cols, got[0][:, i]) for i, lc in enumerate(prods))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 13, 257, "wave+1"])
@pytest.mark.parametrize("f", [mock, fp, fr], ids=["mock", "Fp", "Fr"])
def test_k6_matches_plain_at_caller_bounds(dev, f, lanes):
    """K6 and LazyCols.reduce against the plain reduction on the columns of
    `_caller_columns`, and on a stacked view (lazy_reduce_many's layout)
    read in place."""
    lanes = _lazy_lanes("lazy_redc", f, lanes)
    rng = random.Random(f.L * 1000 + lanes + 6)
    cases = _caller_columns(f, rng, lanes)
    plans = [_reduce_plan(f, lc.hi, wide) for lc, wide in cases]
    if f is not mock:
        assert any(folds > 0 for folds, _ in plans)
    before = kernel_lib.launch_counts["lazy_redc"]
    for (lc, wide), plan in zip(cases, plans):
        want = f.lazy_redc_plain(lc.cols, plan)
        got = (mk.lazy_redc(f, lc.cols.to(dev), plan), LazyCols(f, lc.cols.to(dev), lc.hi).reduce(wide=wide))
        assert all(torch.equal(g.cpu(), want) for g in got), (cases.index((lc, wide)), plan)
    stacked = torch.stack([cases[2][0].cols, cases[3][0].cols], dim=1).to(dev)
    assert torch.equal(mk.lazy_redc(f, stacked[:, 1], plans[3]).cpu(), f.lazy_redc_plain(cases[3][0].cols, plans[3]))
    assert kernel_lib.launch_counts["lazy_redc"] == before + 2 * len(cases) + 1


@pytest.mark.cuda
def test_lazy_wrappers_reject_bad_operands(dev):
    """What K5 and K6 reject on the card: another dtype, mixed devices, an L
    without a kernel, the wrong limb count."""
    x = torch.zeros((fr.L, 16), dtype=torch.int32, device=dev)
    cols = torch.zeros((2 * fr.L, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        mk.lazy_cols(fr, x.long(), x.long())
    with pytest.raises(ValueError):
        mk.lazy_cols(fr, x, x.cpu())
    with pytest.raises(ValueError):
        mk.lazy_redc(fr, cols.long(), (0, 1))
    with pytest.raises(ValueError):
        mk.lazy_redc(fp, cols, (0, 1))
    f6 = LimbField((1 << 50) - 27)  # L = 6: no kernel
    y = torch.zeros((f6.L, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        mk.lazy_cols(f6, y, y)
    with pytest.raises(ValueError):
        mk.lazy_redc(f6, torch.cat([y, y]), (0, 1))


def _count_lazy_calls(monkeypatch):
    """Count LimbField.lazy_mul_many and LazyCols.reduce calls."""
    calls = {"lazy_cols": 0, "lazy_redc": 0}
    mul_many, reduce = LimbField.lazy_mul_many, LazyCols.reduce

    def counted_mul_many(self, *args, **kwargs):
        calls["lazy_cols"] += 1
        return mul_many(self, *args, **kwargs)

    def counted_reduce(self, *args, **kwargs):
        calls["lazy_redc"] += 1
        return reduce(self, *args, **kwargs)

    monkeypatch.setattr(LimbField, "lazy_mul_many", counted_mul_many)
    monkeypatch.setattr(LazyCols, "reduce", counted_reduce)
    return calls


def _lazy_counts():
    return {k: kernel_lib.launch_counts[k] for k in ("lazy_cols", "lazy_redc")}


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_lazy_point_ops_match_cpu(dev, group, monkeypatch):
    """point_add, point_double and scalar_mul_const by the proof's blinding
    r = 27134 on the card give the CPU's raw limbs, one K5 per lazy product
    and one K6 per reduction, and no plain lazy call."""
    from bellman_mpc_tpu_torch.curves import device as cdev

    grp, hostg = (cdev.g1_device, G1) if group == "g1" else (cdev.g2_device, G2)
    rng = random.Random(20)
    pts = [[hostg.mul(hostg.generator, rng.randrange(1, R)) for _ in range(5)] for _ in range(2)]
    pts[1][2] = None  # an identity lane

    def run(device):
        p, q = (grp.encode_points(x, device) for x in pts)
        s = cdev.point_add(grp.ops, p, q)
        return s + cdev.point_double(grp.ops, s) + cdev.scalar_mul_const(grp.ops, p, 27134)

    calls = _count_lazy_calls(monkeypatch)
    kernel_lib.reset_launch_counts()
    got = run(dev)
    torch.cuda.synchronize()
    assert _lazy_counts() == calls and calls["lazy_cols"] > 0
    assert kernel_lib.plain_counts["lazy_cols"] == kernel_lib.plain_counts["lazy_redc"] == 0
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, run("cpu")))


@pytest.mark.cuda
def test_batch_prover_lazy_kernels_match_plain(mimc8, monkeypatch):
    """The rns BatchProver's prove_batch (step and decode) on the card: one
    K5 per lazy product and one K6 per reduction, no plain lazy call, the
    fixture's proofs; then the same with the plain lazy versions on the
    card gives the same proofs."""
    from bellman_mpc_tpu_torch.fields import limb
    from bellman_mpc_tpu_torch.models import MiMCDemo
    from bellman_mpc_tpu_torch.parallel import BatchProver

    eng, params, constants, circuits, want = mimc8
    bp = BatchProver(eng, params, MiMCDemo(constants, 0, 0))
    calls = _count_lazy_calls(monkeypatch)
    kernel_lib.reset_launch_counts()
    assert bp.prove_batch(circuits) == want
    assert _lazy_counts() == calls and calls["lazy_cols"] > 0 and calls["lazy_redc"] > 0
    assert kernel_lib.plain_counts["lazy_cols"] == kernel_lib.plain_counts["lazy_redc"] == 0
    monkeypatch.setattr(limb, "lazy_cols", lambda f, a, b: f.lazy_cols_plain(a, b))
    monkeypatch.setattr(limb, "lazy_redc", lambda f, cols, plan: f.lazy_redc_plain(cols, plan))
    kernel_lib.reset_launch_counts()
    assert bp.prove_batch(circuits) == want
    assert _lazy_counts() == {"lazy_cols": 0, "lazy_redc": 0}
    assert kernel_lib.plain_counts["lazy_cols"] == calls["lazy_cols"] // 2


# ------------------------------------------------ the opt-ins (BMT_GLV, ...)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [57344, 114688])
def test_k1_at_merged_widths(dev, lanes):
    """K1 at the merged G1 fold's widths (57,344 lanes; 114,688 with GLV),
    over two chained windows, sentinels gathered under both signs."""
    rng = random.Random(lanes + 5)
    acc = want = tuple(_tile(rng, lanes, dev) for _ in range(3))
    for _ in range(2):
        q, sg = _k1_inputs(rng, lanes, dev)
        sg[0] = sg[lanes - 1] = True  # sentinel lanes with the sign set
        acc = fk.rns_fold_window(F, 12, acc, q, sg, Fraction(37), Fraction(fk.G1_CAP))
        want = fk.fold_window_g1_plain(F, 12, want, q[0], q[1], sg.to(torch.int32), 37, fk.G1_CAP)
        assert all(torch.equal(g, w) for g, w in zip(acc, want))


@pytest.mark.cuda
def test_k2_at_gls_width(dev):
    """K2 at the GLS-4 G2 fold's width (32,768 lanes), two chained windows."""
    lanes = 32768
    rng = random.Random(lanes + 6)
    acc = want = tuple(_fp2_tile(rng, lanes, dev) for _ in range(3))
    for _ in range(2):
        q, sg = _k2_inputs(rng, lanes, dev)
        sg[0] = sg[lanes - 1] = True
        acc = fk.rns_fold_window_g2(F, 12, acc, q, sg, Fraction(37), Fraction(fk.G2_CAP))
        want = _k2_plain(want, q, sg)
        assert all(torch.equal(g, w) for g, w in zip(acc, want))


@pytest.mark.cuda
def test_glv_decompositions_match_cpu(dev):
    """The GLV-2 / GLS-4 device decompositions on the card (float64 matrix
    products, the digit loops) equal the CPU's."""
    from bellman_mpc_tpu_torch.ops import glv

    rng = random.Random(19)
    ks = [0, 1, R - 1, glv.LAMBDA, glv.LAMBDA + 1] + [rng.randrange(R) for _ in range(251)]
    std = _limbs(fr, ks, "cpu").reshape(fr.L, 16, 16)
    cpu = glv.decompose_glv2_device(std) + glv.decompose_gls4_device(std)
    card = glv.decompose_glv2_device(std.to(dev)) + glv.decompose_gls4_device(std.to(dev))
    assert all(torch.equal(c, g.cpu()) for c, g in zip(cpu, card))
    assert torch.equal(glv.digits_to_bits_msb(card[1]).cpu(), glv.digits_to_bits_msb(cpu[1]))


def _windows(c, nbits):
    return -(-nbits // c) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("env,strategy", [
    ({"BMT_GLV": "1"}, "rns"), ({"BMT_MERGE_G1": "1"}, "rns"),
    ({"BMT_GLV": "1", "BMT_MERGE_G1": "1"}, "rns"),
    ({"BMT_STACK_MSMS": "1"}, "ladder"), ({"BMT_STACK_MSMS": "1"}, "pippenger"),
    ({"BMT_CARRIES": "scan"}, "rns"),
], ids=["glv", "merged", "glv-merged", "stacked-ladder", "stacked-pippenger", "scan-carries"])
def test_batch_prover_opt_ins_match_rns(mimc8, env, strategy, monkeypatch):
    """Each opt-in's BatchProver on the card gives the rns strategy's
    proofs, K1 and K2 once per window of its tables (none for the limb
    strategies), and no plain multiply."""
    from bellman_mpc_tpu_torch.models import MiMCDemo
    from bellman_mpc_tpu_torch.ops.glv import GLS_NBITS, GLV_NBITS
    from bellman_mpc_tpu_torch.parallel import BatchProver

    eng, params, constants, circuits, want = mimc8
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    bp = BatchProver(eng, params, MiMCDemo(constants, 0, 0), msm_strategy=strategy, pippenger_c=4)
    kernel_lib.reset_launch_counts()
    assert bp.prove_batch(circuits) == want
    assert kernel_lib.plain_counts["mont_mul"] == 0 and kernel_lib.launch_counts["mont_mul"] > 0
    g1_bits, g2_bits = (GLV_NBITS, GLS_NBITS) if bp.glv else (255, 255)
    tables = {name: c for name, _, c, _ in bp.table_info()}
    k1 = sum(_windows(c, g1_bits) for name, c in tables.items() if name != "b2")
    k2 = _windows(tables["b2"], g2_bits) if tables else 0
    assert (kernel_lib.launch_counts["rns_fold_window"], kernel_lib.launch_counts["rns_fold_window_g2"]) == (k1, k2)


@pytest.mark.cuda
def test_bench_ntt_quick_on_card(dev, capsys):
    """benches.bench_ntt at quick on the card: K4 once in the warm-up, then
    once per stage of six forward NTTs of 2^10, and no plain multiply."""
    import json

    from bellman_mpc_tpu_torch import benches

    kernel_lib.reset_launch_counts()
    benches.bench_ntt(True, device=dev)
    assert kernel_lib.launch_counts["mont_mul"] == 1 + 6 * 10
    assert kernel_lib.plain_counts["mont_mul"] == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["bench"] == "ntt_fr" and line["n"] == 1024 and line["value"] > 0
    assert line["device"] == torch.cuda.get_device_name(dev)


# --------------------------------------------------------------- the mesh


@pytest.mark.cuda
def test_batch_prover_logical_mesh_matches_table(mimc8):
    """BatchProver on a (2, 2) mesh of logical shards of cuda:0 gives the
    single-device table strategy's proofs (and the rns proofs), with no
    plain multiply and no fold kernel; make_mesh with no devices takes the
    CUDA devices."""
    from bellman_mpc_tpu_torch.models import MiMCDemo
    from bellman_mpc_tpu_torch.parallel import BatchProver, make_mesh

    eng, params, constants, circuits, want = mimc8
    assert make_mesh(1).lead == torch.device("cuda", 0)
    mesh = make_mesh(4, shape=(2, 2), devices=["cuda:0"] * 4)
    bp_table = BatchProver(eng, params, MiMCDemo(constants, 0, 0), msm_strategy="table")
    bp_mesh = BatchProver(eng, params, MiMCDemo(constants, 0, 0), mesh=mesh)
    kernel_lib.reset_launch_counts()
    proofs = bp_mesh.prove_batch(circuits)
    assert kernel_lib.plain_counts["mont_mul"] == 0 and kernel_lib.launch_counts["mont_mul"] > 0
    assert _no_fold()
    assert proofs == bp_table.prove_batch(circuits) == want
