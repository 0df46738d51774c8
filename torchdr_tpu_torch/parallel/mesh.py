"""Device mesh and row-chunk helpers (counterpart of ``torchdr_tpu/parallel/mesh.py``).

The JAX package drives all local chips from one process (SPMD over a
``jax.sharding.Mesh``). The port keeps that design: a :class:`Mesh` is an
ordered tuple of ``torch.device``s driven by one process. The sharded
functions (``parallel/``, ``ops/reduce.pairwise_logkernel_rowlse_sharded``)
launch each shard's work on that shard's device, and the collectives are
explicit: a psum is a sum on the output device in rank order, an
all_to_all an exchange of per-destination buckets, a ppermute the next
shard's tensor moved to this shard's device.

A device may appear more than once. A mesh of ``["cpu"] * 8`` runs every
sharded function on the CPU, beside the JAX package's 8-virtual-device
mesh; a mesh of ``["cuda:0"] * 4`` drives a 4-way mesh on one card.

``row_sharding`` and ``replicated`` build ``NamedSharding``s, which have no
torch meaning, and are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """An ordered tuple of devices with one axis name; ``len(mesh)`` is the
    world size. Devices may repeat."""

    def __init__(self, devices: Sequence, axis: str = "data"):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("[TorchDR-Torch] ERROR : a mesh needs at least one device.")
        self.axis = axis

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def check_mesh(mesh) -> Optional[Mesh]:
    """``mesh`` itself when it is a :class:`Mesh` or None; else TypeError."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"[TorchDR-Torch] ERROR : mesh must be a torchdr_tpu_torch.parallel.Mesh, "
            f"got {type(mesh).__name__}."
        )
    return mesh


@dataclasses.dataclass
class MeshConfig:
    """Configuration of the data-parallel device mesh.

    Parameters
    ----------
    n_devices : int, optional
        Number of devices; default every device of the list.
    axis : str, default "data"
        Mesh axis name for row sharding.
    devices : sequence of devices, optional
        Explicit device list (repeats allowed); default every visible CUDA
        device, raising when there is none.
    """

    n_devices: Optional[int] = None
    axis: str = "data"
    devices: Optional[Sequence] = None

    def build(self) -> Mesh:
        if self.devices is not None:
            devs = list(self.devices)
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "[TorchDR-Torch] ERROR : make_mesh() takes the visible CUDA devices and "
                    "none is available; pass devices=['cpu'] * n for a CPU mesh."
                )
            devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if self.n_devices is not None:
            devs = devs[: self.n_devices]
        return Mesh(devs, self.axis)


def make_mesh(
    n_devices: Optional[int] = None, axis: str = "data", devices: Optional[Sequence] = None
) -> Mesh:
    return MeshConfig(n_devices=n_devices, axis=axis, devices=devices).build()


class ShardedRows(tuple):
    """The per-device row pieces of one matrix (what :func:`shard_rows`
    returns): piece r holds rows ``[r·chunk, (r+1)·chunk)`` on
    ``mesh.devices[r]``, the last one possibly shorter."""

    mesh: Mesh

    def __new__(cls, pieces, mesh: Mesh):
        obj = super().__new__(cls, pieces)
        obj.mesh = mesh
        return obj

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(p.shape[0] for p in self), *self[0].shape[1:])


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def shard_rows(x, mesh: Mesh) -> ShardedRows:
    """Row chunks of ``x`` (chunk = ⌈n / world⌉, as the explicit shard
    kernels cut), each on its shard's device."""
    x = _as_tensor(x)
    chunk = pad_to_multiple(x.shape[0], len(mesh)) // len(mesh)
    pieces = [x[r * chunk : (r + 1) * chunk].to(dev) for r, dev in enumerate(mesh.devices)]
    return ShardedRows(pieces, mesh)


def replicate(x, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """``x`` on every device of the mesh (one copy per distinct device)."""
    x = _as_tensor(x)
    copies = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = x.to(dev)
    return tuple(copies[dev] for dev in mesh.devices)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


# --- chunk arithmetic (reference: torchdr/distributed/__init__.py:183-267) ---


def chunk_bounds(n: int, world: int, rank: int):
    """(start, size) of rank's row chunk; the first ``n % world`` ranks get
    one extra row."""
    base, rem = divmod(n, world)
    size = base + (1 if rank < rem else 0)
    start = rank * base + min(rank, rem)
    return start, size


def rank_of_rows(indices, n: int, world: int):
    """Inverse map row index → owning rank of :func:`chunk_bounds`
    (vectorised; numpy arrays or tensors)."""
    base, rem = divmod(n, world)
    cutoff = rem * (base + 1)
    if isinstance(indices, torch.Tensor):
        idx = indices
        return torch.where(
            idx < cutoff,
            torch.div(idx, base + 1, rounding_mode="floor"),
            rem + torch.div(idx - cutoff, max(base, 1), rounding_mode="floor"),
        )
    idx = np.asarray(indices)
    return np.where(idx < cutoff, idx // (base + 1), rem + (idx - cutoff) // max(base, 1))
