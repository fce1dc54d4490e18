"""Device meshes for the sharded scan, one process or many (counterpart of
``kmergma_tpu.parallel.mesh``).

A mesh has the JAX package's two axes, ("clusters", "data"): its devices
form c rows of d, row c holding data shards 0 ... d - 1 of profile block
c.  ``sharded_scan.sharded_cluster_scan_step`` shards profiles over
"clusters" and genome tiles over "data"; the sharded engines and
``TPScanEngine`` read only "data" (``local_data``, the first row) and
replicate over "clusters", as the JAX engines do.  ``make_mesh(N,
n_clusters=M)`` gives the clusters axis the largest divisor of N up to M
(``_cluster_ways``), the rest to data.

Across processes (``initialize_distributed``: NCCL between cards, gloo
between CPUs) the data axis lays processes outermost, so process p holds
data shards [p L, (p + 1) L) of its L local ones in every row, and the
clusters axis stays inside a process; the only traffic between processes
is an all-gather along the data axis.  Each process names only its own
devices: a ``torch.device`` cannot name another process's card.  By
default a process drives one card, the one its ``LOCAL_RANK`` names (as
``torchrun`` sets it), so that processes on one host never share a card.

``make_mesh(device="cpu")`` and an explicit ``devices=[...]`` list may
repeat one device, as the JAX tests' virtual host devices do: several
logical shards run one after another on that device.  That is for tests
and ``chip_smoke.py``; ``make_mesh(N)`` on the card takes N distinct cards
and raises when fewer are present.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..ops.scan import resolve_device


class NotEnoughDevices(ValueError):
    """A mesh asked for more CUDA devices than are present."""


@dataclass(frozen=True)
class Mesh:
    """This process's part of the mesh, cluster-major: ``devices[c L + j]``
    holds profile block c and local data shard j, L = len(devices) /
    ``clusters``."""

    devices: tuple
    process_count: int = 1
    process_index: int = 0
    #: built over a process group: each pass's bitmap is all-gathered
    distributed: bool = False
    #: ways of the clusters axis (all of them in this process)
    clusters: int = 1

    @property
    def shape(self) -> dict:
        return {"clusters": self.clusters, "data": self.process_count * len(self.devices) // self.clusters}

    @property
    def rows(self) -> list:
        """This process's devices by cluster row: rows[c][j] holds profile
        block c and local data shard j."""
        n = len(self.devices) // self.clusters
        return [list(self.devices[c * n : (c + 1) * n]) for c in range(self.clusters)]

    @property
    def local_data(self) -> list:
        """The devices of this process's data shards, in order: the first
        cluster row, which the one-axis engines shard over."""
        return self.rows[0]

    @property
    def first(self) -> torch.device:
        return self.devices[0]


def _local_card() -> torch.device:
    """This process's own card: ``LOCAL_RANK``, or else the process's rank
    modulo the cards present."""
    import torch.distributed as dist

    if "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    else:
        index = dist.get_rank() % max(torch.cuda.device_count(), 1)
    return resolve_device(torch.device("cuda", index))


#: set by ``initialize_distributed``: the process group is this package's
_JOINED = False


def joined() -> bool:
    """Whether this process joined its process group through
    ``initialize_distributed``, and so runs the package's scans in step
    with the group's other processes (a group made for other work, such as
    data-parallel ranks each scanning their own records, is not read)."""
    import torch.distributed as dist

    return _JOINED and dist.is_available() and dist.is_initialized()


def initialize_distributed(coordinator_address: str | None = None, num_processes: int | None = None, process_id: int | None = None, *, device: "str | torch.device" = "cuda") -> None:
    """Join a process group for meshes across processes (idempotent).

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of
    process 0; without it the group reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` from the environment.  NCCL joins the
    processes' cards (``device="cuda"``, the default), gloo their CPUs; with
    NCCL the process's own card (``LOCAL_RANK``) becomes its current
    device."""
    import torch.distributed as dist

    global _JOINED
    _JOINED = True
    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs = {}
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
    else:
        addr = coordinator_address
        kwargs["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, **kwargs)
    if backend == "nccl":
        torch.cuda.set_device(_local_card())


def _cluster_ways(n_clusters: int, n_devices: int) -> int:
    """Ways of the clusters axis: the largest divisor of ``n_devices`` up
    to ``n_clusters`` (the JAX package's rule)."""
    for cand in range(min(n_clusters, n_devices), 0, -1):
        if n_devices % cand == 0:
            return cand
    return 1


def _devices(n_devices: int | None, device) -> list:
    """The first ``n_devices`` cards (all by default), or on the CPU
    ``n_devices`` logical shards (one by default)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * (1 if n_devices is None else n_devices)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (need a CUDA device or the CPU)")
    if not torch.cuda.is_available():
        resolve_device(dev)  # raises: no CUDA device
    present = torch.cuda.device_count()
    n = present if n_devices is None else n_devices
    if not 1 <= n <= present:
        raise NotEnoughDevices(f"devices={n}: {n} CUDA devices requested, {present} present")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, n_clusters: int = 1, *, device: "str | torch.device" = "cuda", devices: list | None = None) -> Mesh:
    """A ("clusters", "data") mesh over the first ``n_devices`` cards (all
    of them by default), or over ``devices``; ``device="cpu"`` gives
    ``n_devices`` logical shards on the CPU.  The clusters axis takes
    ``_cluster_ways(n_clusters, N)`` ways, the data axis the rest, the
    devices laid out cluster-major.  It never falls back to fewer cards or
    to the CPU: asking for more cards than are present raises
    ``NotEnoughDevices``.  After ``initialize_distributed``, with no
    ``n_devices``, the mesh spans every process (``make_hybrid_mesh``)."""
    import torch.distributed as dist

    if n_devices is None and dist.is_available() and dist.is_initialized():
        return make_hybrid_mesh(n_clusters, device=device, devices=devices)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"devices={n_devices}: need at least one device")
    devs = [resolve_device(d) for d in devices] if devices is not None else _devices(n_devices, device)
    return Mesh(tuple(devs), clusters=_cluster_ways(n_clusters, len(devs)))


def make_hybrid_mesh(n_clusters: int = 1, *, device: "str | torch.device" = "cuda", devices: list | None = None) -> Mesh:
    """A ("clusters", "data") mesh over every process of the process group:
    the clusters axis over this process's local ``devices``
    (``_cluster_ways(n_clusters, L)`` ways), the data axis over the rest
    of them and across processes, processes outermost.  The local devices
    are by default this process's own card (``LOCAL_RANK``; one process
    per card) or one CPU; a process that drives several cards names them
    in ``devices``."""
    import torch.distributed as dist

    if devices is not None:
        devs = [resolve_device(d) for d in devices]
    elif torch.device(device).type == "cpu":
        devs = [torch.device("cpu")]
    else:
        devs = [_local_card()]
    return Mesh(tuple(devs), process_count=dist.get_world_size(), process_index=dist.get_rank(), distributed=True,
                clusters=_cluster_ways(n_clusters, len(devs)))
