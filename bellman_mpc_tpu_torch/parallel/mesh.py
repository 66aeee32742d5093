"""Device meshes for the sharded prover.

Port of bellman_mpc_tpu/parallel/mesh.py.  The reference builds a
`jax.sharding.Mesh` with ("data", "model") axes: the batch-of-proofs axis
is the data-parallel axis and the CRS/MSM base axis the model-parallel one.
Its sharded functions run every shard from one controller (`shard_map`),
and its tests run them on 8 virtual CPU devices.

The port keeps the single controller.  A `Mesh` maps each ("data",
"model") shard coordinate to a `torch.device`, and one device may hold
more than one shard: such logical shards stand in for XLA's virtual
devices, so the same code runs 8 shards on the CPU, several on one card,
or one per card.  The collectives become tensor moves between the shards'
devices (parallel/sharded.py); launches are asynchronous per device, so
shards on distinct cards overlap.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


class Mesh:
    """A (data, model) grid of devices; shard (i, j) runs on `device(i, j)`.

    `lead` is shard (0, 0)'s device: the rest of a prover step runs there,
    and the sharded functions gather their results there."""

    def __init__(self, devices: Sequence, shape: Tuple[int, int]):
        d, m = shape
        devices = [torch.device(x) for x in devices]
        if d < 1 or m < 1 or d * m != len(devices):
            raise ValueError(f"mesh shape {shape} does not hold {len(devices)} devices")
        self.grid = tuple(tuple(devices[i * m:(i + 1) * m]) for i in range(d))
        self.shape = {"data": d, "model": m}
        self.lead = self.grid[0][0]

    def device(self, i: int, j: int) -> torch.device:
        return self.grid[i][j]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={[str(x) for row in self.grid for x in row]})"


def make_mesh(n_devices: Optional[int] = None, shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh over the first n devices.

    `shape` fixes the (data, model) extents; by default everything goes on
    "data" unless n is even and above 2, when model = 2 (the reference's
    rule).  `devices` defaults to the CUDA devices and never falls back to
    the CPU; an explicit list may repeat a device (logical shards), e.g.
    ["cpu"] * 8 for the CPU tests or ["cuda:0"] * 4 on one card."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise RuntimeError(f"make_mesh: {n} devices asked, {len(devices)} available")
    if shape is None:
        shape = (n // 2, 2) if n % 2 == 0 and n > 2 else (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not hold {n} devices")
    return Mesh(devices[:n], shape)


def proof_batch_spec() -> Tuple[Optional[str], ...]:
    """Sharding of (L, B, ...) per-proof tensors: the proof axis over "data"."""
    return (None, "data")


def base_shard_spec() -> Tuple[Optional[str], ...]:
    """Sharding of (L, N) CRS base tensors: the base axis over "model"."""
    return (None, "model")
