"""The lazy Montgomery columns (K5 `lazy_cols`, K6 `lazy_redc`) on the CPU.

* On CPU tensors both wrappers take the plain versions (`mul_cols`, the
  folds of `_reduce_plan` and `redc_cols`) and launch nothing.
* `lazy_mul_many` and `LazyCols.reduce` against the host bigint oracle
  (fields/host.py) on seeded operands whose first lane sits at the digit
  bounds, for the shapes of column arithmetic their callers make: plain
  and digit-sum products, a Karatsuba difference with its offsets, scalings
  up to the int32 edge (a plan with folds before the REDC) and a wide
  reduction (pR <= T < 3pR).  Raw limbs equal the canonical digits of
  (T + M p) / R, M in [0, R), computed with Python ints from the columns'
  value: the function the CUDA kernel computes.
* The wrappers reject a wrong limb count, dtype, rank or device before any
  launch.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import random

import pytest
import torch

from bellman_mpc_tpu_torch.fields.bls12_381 import fp, fp_host, fr, fr_host
from bellman_mpc_tpu_torch.fields.limb import _reduce_plan
from bellman_mpc_tpu_torch.fields.mock import mock, mock_host
from bellman_mpc_tpu_torch.ops import kernel_lib, mont_kernels

torch.set_num_threads(1)  # tiny CPU tensors: threads only contend with the other test workers

FIELDS = [(mock, mock_host), (fr, fr_host), (fp, fp_host)]


def _value(t: torch.Tensor, lane: int) -> int:
    return sum(int(t[i, lane]) << (11 * i) for i in range(t.shape[0]))


def _bound_value(hi) -> int:
    return sum(h << (11 * i) for i, h in enumerate(hi))


def _operands(f, rng, n):
    """Host values below 2p and their (L, n) Montgomery digits; lane 0 holds
    the digit bound `_dmax_lazy` itself (value read back from the digits)."""
    vals = [rng.randrange(2 * f.p) for _ in range(n)]
    t = torch.tensor([[((v * f.R % f.p) >> (11 * i)) & 2047 for v in vals] for i in range(f.L)],
                     dtype=torch.int32)
    t[:, 0] = torch.tensor(f._dmax_lazy, dtype=torch.int32)
    return t, [_value(t, j) * pow(f.R, -1, f.p) % f.p for j in range(n)]


def _closed_form(f, cols: torch.Tensor) -> torch.Tensor:
    """Canonical digits of (T + M p) / R, M = -T p^-1 mod R, per lane."""
    pinv = pow(f.p, -1, f.R)
    out = []
    for j in range(cols.shape[1]):
        t = _value(cols, j)
        v = (t + (-t * pinv) % f.R * f.p) // f.R
        out.append([(v >> (11 * i)) & 2047 for i in range(f.L)])
    return torch.tensor(out, dtype=torch.int32).T


def test_cpu_wrappers_take_the_plain_path(monkeypatch):
    def no_kernel():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(mont_kernels, "load", no_kernel)
    before = dict(kernel_lib.launch_counts), dict(kernel_lib.plain_counts)
    rng = random.Random(1)
    a, _ = _operands(fp, rng, 5)
    b, _ = _operands(fp, rng, 5)
    cols = mont_kernels.lazy_cols(fp, a, b)
    assert torch.equal(cols, fp.mul_cols(a, b))
    plan = _reduce_plan(fp, fp.lazy_mul(a, b).hi, False)
    assert torch.equal(mont_kernels.lazy_redc(fp, cols, plan), fp.redc_cols(cols, fold_steps=plan[1]))
    (lc,) = fp.lazy_mul_many([(a, b)])
    assert torch.equal(lc.reduce(), fp.mul(a, b))  # K4's plain version: the same product fused
    assert (dict(kernel_lib.launch_counts), dict(kernel_lib.plain_counts)) == before


@pytest.mark.parametrize("f,host", FIELDS, ids=["mock", "Fr", "Fp"])
def test_lazy_path_matches_host_oracle(f, host):
    rng = random.Random(f.L)
    n = 9
    (a, xa), (b, xb), (c, xc), (d, xd) = (_operands(f, rng, n) for _ in range(4))
    dm = f._dmax_lazy
    d2 = tuple(2 * x for x in dm)
    t0, t1, t2 = f.lazy_mul_many([(a, b), (c, d), (a + c, b + d)], [(dm, dm), (dm, dm), (d2, d2)])
    k_edge = min(((1 << 31) - 1) // max(t0.hi), (f.p * f.R - 1) // _bound_value(t0.hi))
    folded = t0.fold()
    k_wide = (3 * f.p * f.R - 1) // _bound_value(folded.hi)
    assert k_wide * _bound_value(folded.hi) >= f.p * f.R  # beyond what a narrow reduction admits
    cases = [  # (columns, wide, the host oracle's value per lane)
        (t0, False, lambda j: host.mul(xa[j], xb[j])),
        (t2 - t0 - t1, False, lambda j: host.add(host.mul(xa[j], xd[j]), host.mul(xc[j], xb[j]))),
        (3 * t0 + t1, False, lambda j: host.add(3 * host.mul(xa[j], xb[j]), host.mul(xc[j], xd[j]))),
        (t0.fold().scale(12) - t1, False, lambda j: host.sub(12 * host.mul(xa[j], xb[j]), host.mul(xc[j], xd[j]))),
        (t0.scale(k_edge), False, lambda j: host.mul(k_edge, host.mul(xa[j], xb[j]))),
        (folded.scale(k_wide), True, lambda j: host.mul(k_wide, host.mul(xa[j], xb[j]))),
    ]
    plans = set()
    for lc, wide, want in cases:
        plans.add(_reduce_plan(f, lc.hi, wide))
        got = lc.reduce(wide=wide)
        assert torch.equal(got, _closed_form(f, lc.cols))
        limit = 4 * f.p if wide else 2 * f.p
        assert all(_value(got, j) < limit for j in range(n))
        assert [_value(got, j) * pow(f.R, -1, f.p) % f.p for j in range(n)] == [want(j) for j in range(n)]
    outs = f.lazy_reduce_many([t0, t2 - t0 - t1])
    assert torch.equal(outs[0], cases[0][0].reduce()) and torch.equal(outs[1], cases[1][0].reduce())
    if f is not mock:
        assert any(folds > 0 for folds, _ in plans)  # the scaling at the int32 edge folds first


def test_wrappers_reject_bad_operands(monkeypatch):
    def no_kernel():
        raise AssertionError("a rejected call reached the kernel library")

    monkeypatch.setattr(mont_kernels, "load", no_kernel)
    x = torch.zeros((fr.L, 4), dtype=torch.int32)
    cols = torch.zeros((2 * fr.L, 4), dtype=torch.int32)
    plan = (0, 1)
    bad = [
        lambda: mont_kernels.lazy_cols(fp, x, x),  # 24 limbs for a 36-limb field
        lambda: mont_kernels.lazy_cols(fr, x.long(), x.long()),
        lambda: mont_kernels.lazy_cols(fr, x, x[:, :2]),  # batches that do not broadcast
        lambda: mont_kernels.lazy_cols(fr, x, x[:, :, None]),  # ranks that differ
        lambda: mont_kernels.lazy_cols(fr, torch.zeros((), dtype=torch.int32), x),
        lambda: mont_kernels.lazy_cols(fr, x, x.to("meta")),  # two devices
        lambda: mont_kernels.lazy_redc(fr, x, plan),  # L rows, not 2L
        lambda: mont_kernels.lazy_redc(fp, cols, plan),
        lambda: mont_kernels.lazy_redc(fr, cols.long(), plan),
        lambda: mont_kernels.lazy_redc(fr, torch.zeros((), dtype=torch.int32), plan),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(ValueError):
            call()
