"""Mesh-sharded MSMs and NTT.

Port of bellman_mpc_tpu/parallel/sharded.py.  Mapping of the mesh axes
(parallel/mesh.py):

  * "data"  — the batch of proofs (embarrassingly parallel);
  * "model" — the MSM base axis: each shard reduces its slice of the CRS
    bases, and the partial sums combine with a log-depth recursive-doubling
    butterfly (group addition is not a sum of limb tensors).

The reference runs each function under `shard_map`, one program per
device.  The port runs every shard from this one controller: shard (i,
j)'s blocks are sliced out of the full tensors and moved to its device
(a view where the device is the same), its work is enqueued there, and the
collectives become explicit moves between shard devices: `ppermute` a
`.to(partner)`, `all_to_all` an exchange of blocks.  Results are gathered
on the mesh's lead device.  A block that does not divide by its axis
raises ValueError, where the reference's `shard_map` fails.

Every limb multiply here is `LimbField.mul`, which on the card is K4
(ops/mont_kernels.mont_mul); the point additions are lazy limb columns.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple

import torch

from ..curves.device import point_add, scalar_mul_bits, tree_reduce
from ..fields.host import PrimeField
from ..fields.limb import LimbField
from ..ops.domain import ntt as local_ntt
from ..ops.domain import warm_twiddles
from ..ops.msm import msm_table, msm_table_affine
from .mesh import Mesh, base_shard_spec, proof_batch_spec


def _on(device: torch.device):
    """Make `device` current for the block (a CUDA kernel launches on the
    current device's stream)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _last_axis(spec: Tuple, rank: int) -> Tuple:
    """A (None, ..., name) spec widened to `rank` axes: the named axis stays last."""
    return (None,) * (rank - len(spec)) + tuple(spec)


def _block(mesh: Mesh, t: torch.Tensor, spec: Sequence, i: int, j: int) -> torch.Tensor:
    """Shard (i, j)'s block of `t` on its device: each axis named "data" or
    "model" in `spec` (leading axes first) is split evenly over that mesh
    axis."""
    idx = []
    for k, name in enumerate(spec):
        if name is None:
            idx.append(slice(None))
            continue
        parts, size = mesh.shape[name], t.shape[k]
        if size % parts:
            raise ValueError(f"axis {k} of size {size} does not divide over the {parts} {name!r} shards")
        step = size // parts
        r = i if name == "data" else j
        idx.append(slice(r * step, (r + 1) * step))
    return t[tuple(idx)].to(mesh.device(i, j))


class BaseShards:
    """Coordinate tensors with their last (base) axis split over "model",
    each shard's slice placed on its device once (BatchProver's tables);
    `full` keeps the unsplit tensors."""

    def __init__(self, mesh: Mesh, coords: Tuple[torch.Tensor, ...]):
        self.mesh = mesh
        self.full = coords
        spec = _last_axis(base_shard_spec(), coords[0].dim())
        d, m = mesh.shape["data"], mesh.shape["model"]
        self.parts: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {
            (i, j): tuple(_block(mesh, x, spec, i, j) for x in coords)
            for i in range(d) for j in range(m)}


def _bases(mesh: Mesh, coords, i: int, j: int) -> Tuple[torch.Tensor, ...]:
    if isinstance(coords, BaseShards):
        if coords.mesh is not mesh:
            raise ValueError("the base shards were placed for another mesh")
        return coords.parts[(i, j)]
    spec = _last_axis(base_shard_spec(), coords[0].dim())
    return tuple(_block(mesh, x, spec, i, j) for x in coords)


def _check_butterfly(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"the butterfly combine needs a power-of-two 'model' extent, got {n}")


def _butterfly_combine(ops, parts: list, devices: Sequence[torch.device]) -> list:
    """All-reduce of group-point partials over the "model" shards in
    log2(D) steps: at step s every shard adds the running partial of the
    shard whose index differs in bit s, moved to its own device, so after
    log2(D) steps every shard holds the full sum (the reference's ppermute
    butterfly).  The reference gives a wrong sum when D is not a power of
    two; here that raises ValueError."""
    n = len(parts)
    _check_butterfly(n)
    step = 1
    while step < n:
        new = []
        for i, dev in enumerate(devices):
            with _on(dev):
                other = tuple(x.to(dev) for x in parts[i ^ step])
                new.append(point_add(ops, parts[i], other))
        parts = new
        step *= 2
    return parts


def _sharded_reduce(mesh: Mesh, ops, local):
    """Run `local(i, j)` -> partial point (L, [2,] B_loc, 1) on every shard,
    combine each data row's partials with the butterfly, and gather the
    rows' sums on the lead device: (L, [2,] B, 1)."""
    _check_butterfly(mesh.shape["model"])  # before any shard's work
    rows = []
    for i, devs in enumerate(mesh.grid):
        parts = []
        for j, dev in enumerate(devs):
            with _on(dev):
                parts.append(local(i, j))
        rows.append(_butterfly_combine(ops, parts, devs)[0])
    return tuple(torch.cat([r[k].to(mesh.lead) for r in rows], dim=-2) for k in range(3))


def _scalar_spec() -> Tuple:
    """(W or NBITS, B, N) scalars: the proofs over "data", the bases over "model"."""
    return proof_batch_spec() + ("model",)


def sharded_msm(mesh: Mesh, ops, points, bits: torch.Tensor):
    """MSM with the bases sharded over "model" and the proofs over "data":
    per shard the ladder (scalar_mul_bits over its bases broadcast over its
    proofs) and a tree sum, then the butterfly.

    points: coord tuple, each (L, [2,] N) (or BaseShards); bits: (NBITS, B,
    N).  Returns (L, [2,] B, 1) on the lead device."""

    def local(i, j):
        b = _block(mesh, bits, _scalar_spec(), i, j)
        per = tuple(x[..., None, :].expand(tuple(x.shape[:-1]) + tuple(b.shape[-2:]))
                    for x in _bases(mesh, points, i, j))
        return tree_reduce(ops, scalar_mul_bits(ops, per, b))

    return _sharded_reduce(mesh, ops, local)


def sharded_msm_table(mesh: Mesh, ops, tables, digits: torch.Tensor):
    """Gather-table MSM (ops.msm.msm_table) with the base axis over "model"
    and the proofs over "data": each shard folds its base slice with the
    single-device function, then the butterfly.

    tables: coord tuple (L, [2,] W, 2^c, N) from `window_tables` (or
    BaseShards of it); digits: (W, B, N).  Returns (L, [2,] B, 1)."""

    def local(i, j):
        return msm_table(ops, _bases(mesh, tables, i, j), _block(mesh, digits, _scalar_spec(), i, j))

    return _sharded_reduce(mesh, ops, local)


def sharded_msm_table_affine(mesh: Mesh, ops, tables, sdigits: torch.Tensor):
    """Signed-affine gather-table MSM (ops.msm.msm_table_affine, the table
    strategy's default) with the base axis over "model" and the proofs over
    "data".  Each shard runs the unmodified single-device fold on its base
    slice (the (0, 0) identity sentinel and the complete mixed addition make
    slices independent), then the butterfly: the mesh form of the
    reference's window-parallel Pippenger (bellman/src/multiexp.rs:238-249),
    applied to the base axis.

    tables: (x, y) coord tuple (L, [2,] W, nb, N) from
    `window_tables_affine` (or BaseShards of it); sdigits: (W, B, N) signed
    digits.  Returns (L, [2,] B, 1)."""

    def local(i, j):
        return msm_table_affine(ops, _bases(mesh, tables, i, j), _block(mesh, sdigits, _scalar_spec(), i, j))

    return _sharded_reduce(mesh, ops, local)


_NTT_CONSTS: Dict[tuple, tuple] = {}


def _powers(w: int, n: int, p: int):
    out, x = [], 1
    for _ in range(n):
        out.append(x)
        x = x * w % p
    return out


def _ntt_consts(field: LimbField, host: PrimeField, n: int, devices: Sequence[torch.device], inverse: bool):
    """Per "model" shard j on devices[j]: its n2 slice of the twiddle matrix
    T[k1, n2] = omega^(k1 n2), the size-N1 DFT matrix W[k1, n1] =
    omega_N1^(k1 n1) and, on inverse, 1/N1, all Montgomery limbs; built on
    the host once per (field, n, shards, inverse, devices), as warm_twiddles
    caches the local transform's."""
    key = (id(field), id(host), n, inverse, tuple(str(d) for d in devices))
    if key not in _NTT_CONSTS:
        p, L = host.p, field.L
        D = len(devices)
        N1, N2 = D, n // D
        omega = host.nth_root_of_unity(n.bit_length() - 1)
        if inverse:
            omega = host.inv(omega)
        w_n1 = pow(omega, N2, p)  # a primitive N1-th root
        tw = field.encode([v for k1 in range(N1) for v in _powers(pow(omega, k1, p), N2, p)]).reshape(L, N1, N2)
        dft1 = field.encode([v for k1 in range(N1) for v in _powers(pow(w_n1, k1, p), N1, p)]).reshape(L, N1, N1)
        minv1 = field.encode([host.inv(N1)]) if inverse else None
        n2l = N2 // D
        _NTT_CONSTS[key] = tuple(
            (tw[:, :, j * n2l:(j + 1) * n2l].to(dev), dft1.to(dev), None if minv1 is None else minv1.to(dev))
            for j, dev in enumerate(devices))
    return _NTT_CONSTS[key]


def sharded_ntt(mesh: Mesh, field: LimbField, host: PrimeField, x: torch.Tensor, inverse: bool = False):
    """Radix-2 NTT over the trailing axis of an (L, *batch, N) limb tensor,
    distributed over the "model" shards by the 4-step (N1 x N2)
    decomposition, N1 = the "model" extent: the mesh form of the
    reference's 2-level parallel FFT (bellman/src/domain.rs:316-372), its
    shared-memory interleave an exchange of blocks between the shards.

    Returns the same-order transform as ops.domain.ntt, on the lead device.
    The reference takes (L, N) and vmaps its callers over a batch; here the
    batch axes ride along.  The input is replicated over "data" in the
    reference, so every data row there computes the same transform; here
    data row 0's shards compute it once."""
    devs = mesh.grid[0]
    D = len(devs)
    N = x.shape[-1]
    if D == 1:
        with _on(mesh.lead):
            return local_ntt(field, host, x.to(mesh.lead), inverse=inverse)
    N1, N2 = D, N // D
    if N % D or N2 % D or N1 & (N1 - 1) or N2 & (N2 - 1):
        raise ValueError(f"the 4-step NTT over {D} shards needs powers of two with N / {D} "
                         f"divisible by {D}, got N = {N}")
    warm_twiddles(field, host, N2.bit_length() - 1)
    consts = _ntt_consts(field, host, N, devs, inverse)
    L, lead_shape = field.L, tuple(x.shape[:-1])
    ones = (1,) * (len(lead_shape) - 1)  # the batch axes
    xm = x.reshape(lead_shape + (N1, N2))
    n2l = N2 // D
    b = []
    for j, dev in enumerate(devs):
        tw, dft1, _ = consts[j]
        with _on(dev):
            xl = xm[..., j * n2l:(j + 1) * n2l].to(dev)  # (L, *batch, N1, N2/D): shard j's n2 slice
            # step 1, the size-N1 DFT over n1: A[k1, .] = sum_n1 W[k1, n1] x[n1, .]
            prod = field.mul(dft1.reshape((L,) + ones + (N1, N1, 1)), xl.unsqueeze(-3))
            a = prod[..., 0, :]
            for n1 in range(1, N1):
                a = field.add(a, prod[..., n1, :])
            # step 2, the twiddle by omega^(k1 n2)
            b.append(field.mul(a, tw.reshape((L,) + ones + (N1, n2l))))
    rows = N1 // D
    c = []
    for r, dev in enumerate(devs):
        with _on(dev):
            # step 3, the all-to-all: shard r takes its k1 rows from every shard,
            # concatenated over n2 (split axis k1, concat axis n2, tiled)
            bt = torch.cat([b[j][..., r * rows:(r + 1) * rows, :].to(dev) for j in range(D)], dim=-1)
            # step 4, the size-N2 NTT of each row: omega^N1 is the canonical
            # size-N2 root, so the local transform's cached twiddles apply; on
            # inverse it scales by 1/N2 and the 1/N1 is left to here
            cr = local_ntt(field, host, bt, inverse=inverse)
            if inverse:
                cr = field.mul(cr, consts[r][2].reshape((L,) + ones + (1, 1)))
            c.append(cr)
    out = torch.cat([cr.to(mesh.lead) for cr in c], dim=-2)  # (L, *batch, N1, N2), k1 on axis -2
    # X[k1 + N1 k2] = C[k1, k2]: transpose to k2-major, the natural order
    return out.transpose(-1, -2).reshape(lead_shape + (N,))


def shard_batch_inputs(mesh: Mesh, arrays: Sequence[torch.Tensor], batch_axis: int = 1):
    """Check that each per-proof tensor's proof axis divides over "data" and
    place it on the lead device.  The split itself happens inside the
    sharded functions, which take each shard's block as `shard_map` does."""
    d = mesh.shape["data"]
    out = []
    for a in arrays:
        if a.shape[batch_axis] % d:
            raise ValueError(f"batch axis of size {a.shape[batch_axis]} does not divide over {d} 'data' shards")
        out.append(a.to(mesh.lead))
    return tuple(out)
