"""Device meshes for one controller.

The port of ``optionslab_tpu/parallel/mesh.py``. A :class:`Mesh` is a grid
of ``torch.device`` s with the axes

  * ``"book"``  — contracts / data parallel (each device prices a slice of
    the book, or trains on a slice of the quote batch);
  * ``"paths"`` — Monte Carlo sample parallel (each device simulates a
    disjoint range of global path blocks).

There is no ``torch.distributed`` here: one process issues every shard's
work on that shard's device, moves the results to the mesh's first device
with ``.to()`` (the reference's ``psum``/``all_gather``) and reduces them
there in shard order. What a sharded call computes depends only on which
device owns which global blocks and on that order, so a device may appear
more than once in a mesh: ``[torch.device("cpu")] * 8`` stands in for eight
devices, and ``[torch.device("cuda", 0)] * 4`` runs a 4-shard mesh on one
card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BOOK_AXIS = "book"
PATH_AXIS = "paths"


class Mesh:
    """A (book, paths) grid of devices, row-major: ``devices[i, j]`` is the
    device of book slice ``i`` and path slice ``j``."""

    def __init__(self, devices, axis_names=(BOOK_AXIS, PATH_AXIS)):
        grid = np.asarray(devices, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(grid[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs {grid.ndim} axis names, "
                             f"got {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> list:
        """Every device in linear (row-major) order: the shard order."""
        return list(self.devices.ravel())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_list()})"


def _visible_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible; pass devices=[...] "
                           "(for example [torch.device('cpu')] * 8) to build a mesh without one")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, book: int = 1, devices=None) -> Mesh:
    """A (book, paths) mesh over the first ``n_devices`` devices.

    ``book`` devices are assigned to the contract axis, the rest to the path
    axis (``n_devices`` must be divisible by ``book``). ``devices`` defaults
    to every visible CUDA device; with none visible this raises (a mesh
    never falls back to the CPU). Devices may repeat.
    """
    devices = list(devices if devices is not None else _visible_devices())
    n = n_devices or len(devices)
    if n % book:
        raise ValueError(f"n_devices={n} not divisible by book={book}")
    if n > len(devices):
        raise ValueError(f"n_devices={n} but only {len(devices)} devices were given")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(grid.reshape(book, n // book), (BOOK_AXIS, PATH_AXIS))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which mesh axis a tensor's leading axis is split over (``None``:
    replicated on every device)."""

    mesh: Mesh
    axis: str | None

    def devices(self) -> list:
        """The device of each piece, in piece order."""
        if self.axis is None:
            return self.mesh.device_list()
        k = self.mesh.axis_names.index(self.axis)
        return list(np.moveaxis(self.mesh.devices, k, 0)[:, 0])


def path_sharding(mesh: Mesh) -> Sharding:
    """Sharding for a (paths, ...) tensor: paths split over the path axis."""
    return Sharding(mesh, PATH_AXIS)


def book_sharding(mesh: Mesh) -> Sharding:
    """Sharding for a (contracts, ...) tensor: contracts over the book axis."""
    return Sharding(mesh, BOOK_AXIS)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard(x: torch.Tensor, sharding: Sharding) -> list:
    """``x`` split along its leading axis into equal pieces, piece ``j`` on
    the device of slice ``j`` of the sharding's axis (a replicated sharding
    gives one copy per device). The length must divide evenly."""
    devs = sharding.devices()
    if sharding.axis is None:
        return [x.to(d) for d in devs]
    if x.shape[0] % len(devs):
        raise ValueError(f"leading axis {x.shape[0]} not divisible by the "
                         f"{sharding.axis} axis size {len(devs)}")
    return [piece.to(d) for piece, d in zip(torch.chunk(x, len(devs)), devs)]


def unshard(pieces, sharding: Sharding | None = None) -> torch.Tensor:
    """The pieces of :func:`shard` joined on the first piece's device (a
    replicated sharding returns the first copy)."""
    if sharding is not None and sharding.axis is None:
        return pieces[0]
    dev = pieces[0].device
    return torch.cat([p.to(dev) for p in pieces])
