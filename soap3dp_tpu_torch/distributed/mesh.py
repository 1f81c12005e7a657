"""Multi-device scaling: read-sharded data parallelism over a device mesh.

Port of soap3dp_tpu/distributed/mesh.py (same function names). The
reference scales by one process per GPU over a shared index; the JAX
package by one process driving a ``jax.sharding.Mesh``. Here:

* a ``DeviceMesh`` (an ordered tuple of torch devices and an axis name)
  takes the place of the JAX mesh;
* ``replicate_index`` uploads the index once per distinct device and
  returns a ``MeshIndex``: the first replica itself (code that runs on
  one device uses it unchanged) carrying the mesh and one DeviceIndex
  per mesh position. Every sharding stage (seed search, DP seeding,
  banded DP) finds them through ``mesh_of`` / ``replicas_of``, as the
  JAX stages find their mesh through the index's sharding;
* a sharded array is a tuple of per-device tensors (``shard_rows``),
  and a shard's work runs on its device in a host thread of its own
  (``map_shards``): the JAX ``shard_map``;
* the ``psum`` of a global count is the host sum of the shards' counts;
  across processes the CLI adds a torch.distributed all-reduce
  (cli/runner.py).

A device may appear more than once: two replicas on one card, or
several CPU "devices" (the analog of the tests' 8 virtual CPU devices).
Replicas on one device share one upload.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from soap3dp_tpu_torch.index.builder import Index
from soap3dp_tpu_torch.fm import fmindex
from soap3dp_tpu_torch.fm.fmindex import DeviceIndex


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """An ordered tuple of devices along one axis."""

    devices: tuple[torch.device, ...]
    axis: str = "reads"

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass
class MeshIndex(DeviceIndex):
    """A DeviceIndex replicated over a mesh: its own fields are replica
    0's; ``replicas[j]`` is the index on ``mesh.devices[j]``."""

    mesh: DeviceMesh | None = None
    replicas: tuple = ()


def make_mesh(devices=None, axis: str = "reads") -> DeviceMesh:
    """A mesh of ``devices`` (default: every CUDA card). A mesh of CPU
    devices is asked for by name (``["cpu"] * n``): with no devices
    given and no card, this raises rather than run on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): no CUDA card; name the devices "
                               "(e.g. ['cpu'] * 2) for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return DeviceMesh(tuple(torch.device(d) for d in devices), axis)


def mesh_of(didx: DeviceIndex) -> DeviceMesh | None:
    """The mesh a DeviceIndex was replicated onto, or None (one device)."""
    m = getattr(didx, "mesh", None)
    return m if m is not None and m.size > 1 else None


def replicas_of(didx: DeviceIndex) -> tuple[DeviceIndex, ...]:
    """One DeviceIndex per mesh position; ``(didx,)`` off a mesh."""
    return didx.replicas if mesh_of(didx) is not None else (didx,)


def pad_to_mesh(mesh: DeviceMesh | None, n: int, quantum: int = 1) -> int:
    """Smallest padded size >= n that is a multiple of mesh_size*quantum;
    ``n`` itself off a mesh (``mesh_of`` gave None)."""
    if mesh is None:
        return int(n)
    q = mesh.size * quantum
    return max(q, -(-int(n) // q) * q)


def split_rows(devices, a: np.ndarray) -> tuple[torch.Tensor, ...]:
    """Host rows (a multiple of len(devices)) -> equal contiguous slices,
    slice j a tensor on devices[j]."""
    a = np.asarray(a)
    if a.shape[0] % len(devices):
        raise ValueError(f"{a.shape[0]} rows do not split evenly over "
                         f"{len(devices)} devices (pad_to_mesh first)")
    return tuple(fmindex.to_device(part, dev)
                 for part, dev in zip(np.split(a, len(devices)), devices))


def shard_rows(mesh: DeviceMesh, *arrays):
    """Split each array's rows over the mesh (see split_rows): a tuple of
    per-device tensors per array. Rows must already be padded to a
    multiple of the mesh size (pad_to_mesh)."""
    out = tuple(split_rows(mesh.devices, a) for a in arrays)
    return out if len(out) > 1 else out[0]


def map_shards(devices, fn) -> list:
    """``[fn(j) for j in range(len(devices))]``, one host thread per
    position when there are several, so one shard's host waits (copies,
    syncs) overlap the others' work; ctypes kernel calls and torch's
    waits release the interpreter lock. Results in order; the first
    exception is raised."""
    if len(devices) == 1:
        return [fn(0)]
    with ThreadPoolExecutor(len(devices)) as ex:
        futures = [ex.submit(fn, j) for j in range(len(devices))]
        return [f.result() for f in futures]


def replicate_index(index: Index, mesh: DeviceMesh, shard_sa: bool = False
                    ) -> MeshIndex:
    """Upload the index to every device of the mesh (once per distinct
    device).

    With ``shard_sa`` the SA-sample table, the one large and rarely
    touched array, is split into equal zero-padded slices, slice j on
    mesh device j, instead of replicated; sa_decode routes each lookup
    to the slice's device. Everything else stays replicated."""
    uploads: dict[torch.device, DeviceIndex] = {}
    for dev in mesh.devices:
        if dev not in uploads:
            uploads[dev] = fmindex.device_index(index, dev)
    reps = [uploads[dev] for dev in mesh.devices]
    if shard_sa:
        sa = np.asarray(index.sa_samples)
        sa = np.concatenate([sa, np.zeros((-len(sa)) % mesh.size, sa.dtype)])
        parts = tuple(fmindex._upload(p, dev) for p, dev in
                      zip(np.split(sa, mesh.size), mesh.devices))
        reps = [dataclasses.replace(r, sa_samples=parts[j], sa_parts=parts)
                for j, r in enumerate(reps)]
    first = {f.name: getattr(reps[0], f.name)
             for f in dataclasses.fields(DeviceIndex)}
    return MeshIndex(**first, mesh=mesh, replicas=tuple(reps))


def shard_batch(mesh: DeviceMesh, reads: np.ndarray, lens: np.ndarray):
    """Zero-pad the batch to a multiple of the mesh size and split it:
    (per-device reads, per-device lens, real batch size)."""
    B = reads.shape[0]
    pad = (-B) % mesh.size
    if pad:
        reads = np.pad(reads, ((0, pad), (0, 0)))
        lens = np.pad(lens, (0, pad))
    return shard_rows(mesh, reads, lens) + (B,)


def _search_shards(didx: DeviceIndex, reads, lens, cfg, max_steps: int):
    """Each shard's lossless search and its aligned-read count."""
    from soap3dp_tpu_torch.fm.search import _search_batch

    reps = replicas_of(didx)

    def step(j):
        hits, _ = _search_batch(reps[j], reads[j], lens[j], cfg, cfg.occ_cap,
                                max_steps)
        Bs = reads[j].shape[0]
        read_of = torch.where(hits.row >= Bs, hits.row - Bs, hits.row)
        aligned = torch.zeros(Bs, dtype=torch.int64, device=read_of.device)
        aligned.index_put_((read_of.clamp(0, Bs - 1),),
                           hits.valid.to(torch.int64), accumulate=True)
        return hits, int((aligned > 0).sum())

    return map_shards([r.device for r in reps], step)


def sharded_search(didx: DeviceIndex, reads, lens, cfg, max_steps: int):
    """Data-parallel seed search over the index's mesh: one lossless
    _search_batch per shard (the shards of shard_batch), the hits joined
    with batch-global row ids."""
    return alignment_step(mesh_of(didx), didx, reads, lens, cfg,
                          max_steps)[0]


def alignment_step(mesh: DeviceMesh, didx: DeviceIndex, reads, lens, cfg,
                   max_steps: int):
    """One full sharded search step + the global aligned-read count, the
    sum over shards of the reads with a valid hit (the JAX psum)."""
    from soap3dp_tpu_torch.fm.search import HitArrays, _join_shards

    parts = _search_shards(didx, reads, lens, cfg, max_steps)
    hits = _join_shards([HitArrays(*h.to_host()) for h, _ in parts],
                        reads[0].shape[0])
    return hits, sum(n for _, n in parts)
