"""The multi-rank runtime and rank meshes over ``torch.distributed``.

Every process of a job runs the same program (SPMD) and drives one
device. :func:`initialize_distributed` joins the job's process group;
:func:`make_mesh` / :func:`make_mesh_2d` lay the job's ranks out as a
1-D (Z) or 2-D (Z x Y) grid, a :class:`RankMesh`, which
``parallel.predict_sharded`` shards its patch grid over and the
data-parallel ``Trainer(mesh=)`` its batches. :func:`replicated` and
:func:`sharded_first_axis` are the Trainer's placements (the JAX
package's ``NamedSharding(mesh, P())`` and ``P(axis)``). The collectives
here (``all_reduce``, ``all_gather``, broadcast, forward neighbour strip
exchange, a barrier) run over NCCL with device tensors, and over gloo
with tensors staged through the host.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from aind_exaspim_neuron_segmentation_tpu_torch.core.device import (
    resolve_device,
)


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _initialized():
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device=None, **kwargs):
    """Join the job's process group; safe to call unconditionally.

    The job comes from the arguments or the environment, under either
    contract:

    * the JAX package's: ``JAX_COORDINATOR_ADDRESS`` (or
      ``COORDINATOR_ADDRESS``) ``host:port``, ``JAX_NUM_PROCESSES``,
      ``JAX_PROCESS_ID``;
    * torchrun's: ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
      ``RANK`` (and ``LOCAL_RANK``).

    A single process (no coordinator, or one process) returns False
    without touching ``torch.distributed``; a second call on a joined
    process group does nothing. Returns True when a multi-rank group is
    up.

    ``device``: the ranks' device (default ``cuda``, which raises
    without a card). On CUDA each rank drives ``cuda:LOCAL_RANK`` (or
    ``process_id`` modulo the card count) and the backend is ``nccl``;
    on the CPU it is ``gloo``. ``backend=`` (or ``EXA_DIST_BACKEND``)
    names another, e.g. gloo for several ranks on one card, which NCCL
    refuses. Other ``kwargs`` go to ``init_process_group``.
    """
    if _initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator_address = (
        coordinator_address
        or env.get("JAX_COORDINATOR_ADDRESS")
        or env.get("COORDINATOR_ADDRESS")
    )
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (
            f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        )
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if coordinator_address is None or (num_processes or 1) <= 1:
        return False  # single-process run: nothing to do
    if process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address} and {num_processes} "
            "processes given, but no process id (JAX_PROCESS_ID or RANK)"
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = dev.index
        if local is None:
            local = _env_int("LOCAL_RANK")
            local = process_id if local is None else local
            local %= torch.cuda.device_count()
        torch.cuda.set_device(local)
    kwargs.setdefault(
        "backend",
        env.get("EXA_DIST_BACKEND") or ("nccl" if dev.type == "cuda"
                                        else "gloo"),
    )
    dist.init_process_group(
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), **kwargs,
    )
    return dist.get_world_size() > 1


class RankMesh:
    """A grid of the job's ranks, one device per rank.

    ``devices``: the global ranks laid out as the grid (``shape``, one
    entry per axis of ``axis_names``); ``size``: how many. ``rank``: this
    process's global rank, ``coords``: its grid coordinates (None when it
    is not in the mesh). ``group``: the ``torch.distributed`` process
    group of the mesh's ranks (None without a process group, when the
    mesh is this one process). :meth:`neighbor` names the ranks beside
    this one.
    """

    def __init__(self, ranks, axis_names):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-D rank grid for axes {self.axis_names}"
            )
        self.shape = self.devices.shape
        self.size = int(self.devices.size)
        world = dist.get_world_size() if _initialized() else 1
        flat = sorted(int(r) for r in self.devices.ravel())
        if len(set(flat)) != len(flat) or flat[0] < 0 or flat[-1] >= world:
            raise ValueError(
                f"mesh ranks {flat} are not distinct ranks of a job of "
                f"{world}"
            )
        self.rank = dist.get_rank() if _initialized() else 0
        hit = np.argwhere(self.devices == self.rank)
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None
        self.group = None
        if _initialized():
            # a collective: every rank of the job builds the same mesh
            self.group = (dist.group.WORLD if flat == list(range(world))
                          else dist.new_group(ranks=flat))

    def neighbor(self, axis, step=1):
        """Global rank ``step`` places along ``axis`` from this rank, or
        None past the grid's edge (or when this rank is not in it)."""
        if self.coords is None:
            return None
        coords = list(self.coords)
        coords[axis] += step
        if not 0 <= coords[axis] < self.shape[axis]:
            return None
        return int(self.devices[tuple(coords)])

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in
                         zip(self.axis_names, self.shape))
        return f"RankMesh({axes}; rank {self.rank} at {self.coords})"


def _ranks(n, devices):
    ranks = list(devices if devices is not None else range(
        dist.get_world_size() if _initialized() else 1))
    n = n or len(ranks)
    if len(ranks) < n:
        raise ValueError(
            f"need {n} ranks, have {len(ranks)}: start one process per "
            "device (e.g. torchrun --nproc_per_node) and call "
            "initialize_distributed first"
        )
    return ranks[:n]


def make_mesh(n_devices=None, axis_name="shard", devices=None):
    """1-D mesh over the first ``n_devices`` ranks of ``devices`` (global
    ranks; default every rank of the job). Every process calls it with
    the same arguments."""
    return RankMesh(_ranks(n_devices, devices), (axis_name,))


def make_mesh_2d(shape, axis_names=("z", "y"), devices=None):
    """2-D mesh (e.g. Z x Y slab sharding for ``predict_sharded``), ranks
    in row-major order. Every process calls it with the same arguments."""
    n = int(np.prod(shape))
    return RankMesh(
        np.asarray(_ranks(n, devices)).reshape(shape), tuple(axis_names)
    )


def _group(spec):
    return spec.group if isinstance(spec, RankMesh) else spec


def _staged(t, group):
    """Whether ``t`` crosses ``group`` through the host: gloo moves only
    host tensors."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce_sum(t, spec=None):
    """SUM ``t`` over the ranks of ``spec`` (a :class:`RankMesh`, a process
    group, or None for the whole job); returns the sum on ``t``'s device.
    Without a process group it returns ``t``."""
    if not _initialized():
        return t
    group = _group(spec)
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    dist.all_reduce(t, group=group)
    return t


def all_gather(t, spec=None):
    """Every rank's ``t`` (same shape and dtype on each) over the ranks of
    ``spec``, as a list in group rank order on ``t``'s device; ``[t]``
    without a process group."""
    if not _initialized():
        return [t]
    group = _group(spec)
    src = t.cpu() if _staged(t, group) else t.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


class Placement:
    """Where the Trainer puts a tensor on a :class:`RankMesh`: on every
    rank (``axis`` None, :func:`replicated`) or split by its leading axis
    over the mesh axis ``axis`` into contiguous blocks in block order
    (:func:`sharded_first_axis`), replicated over the other mesh axes."""

    def __init__(self, mesh, axis=None):
        self.mesh = mesh
        self.axis = None if axis is None else mesh.axis_names.index(axis)

    @property
    def blocks(self):
        """How many blocks the leading axis splits into."""
        return 1 if self.axis is None else self.mesh.shape[self.axis]

    def rows(self, n):
        """This rank's ``[lo, hi)`` of ``n`` leading rows."""
        if n % self.blocks:
            raise ValueError(
                f"{n} rows do not divide over {self.blocks} blocks")
        if self.axis is None:
            return 0, n
        if self.mesh.coords is None:
            raise ValueError(f"rank {self.mesh.rank} is not in {self.mesh}")
        b, size = self.mesh.coords[self.axis], n // self.blocks
        return b * size, (b + 1) * size

    @torch.no_grad()
    def place(self, t):
        """This rank's part of ``t``: its block of rows, or for a
        replicated placement ``t`` itself, overwritten in place with the
        mesh's first rank's ``t``."""
        if self.axis is not None:
            lo, hi = self.rows(t.shape[0])
            return t[lo:hi]
        group = self.mesh.group
        if group is not None and self.mesh.size > 1:
            src = int(self.mesh.devices.flat[0])
            host = t.cpu() if _staged(t, group) else t
            dist.broadcast(host, src, group=group)
            if host is not t:
                t.copy_(host)
        return t

    def gather(self, t):
        """The whole of a sharded tensor from every rank's block ``t``,
        blocks in order, on ``t``'s device (``t`` when replicated)."""
        if self.axis is None or self.blocks == 1:
            return t
        parts = all_gather(t, self.mesh)
        order = sorted(int(r) for r in self.mesh.devices.ravel())
        holders = [int(np.take(self.mesh.devices, b, axis=self.axis).flat[0])
                   for b in range(self.blocks)]
        return torch.cat([parts[order.index(r)] for r in holders])


def replicated(mesh):
    """The same tensor on every rank of ``mesh`` (its first rank's)."""
    return Placement(mesh)


def sharded_first_axis(mesh, axis_name="shard"):
    """The leading axis split over the mesh axis ``axis_name``."""
    return Placement(mesh, axis_name)


def shift_forward(t, mesh, axis):
    """Send ``t`` to the next rank along ``axis`` and return what the
    previous rank sent (same shape and dtype), or None on the first rank
    of the axis. The last rank of the axis sends nothing."""
    nxt, prv = mesh.neighbor(axis, 1), mesh.neighbor(axis, -1)
    if nxt is None and prv is None:
        return None
    staged = _staged(t, mesh.group)
    ops, recv = [], None
    if nxt is not None:
        send = (t.cpu() if staged else t).contiguous()
        ops.append(dist.P2POp(dist.isend, send, nxt, mesh.group))
    if prv is not None:
        recv = torch.empty(t.shape, dtype=t.dtype,
                           device="cpu" if staged else t.device)
        ops.append(dist.P2POp(dist.irecv, recv, prv, mesh.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return None if recv is None else recv.to(t.device)


def barrier(mesh):
    """Wait for every rank of ``mesh`` (nothing without a process group)."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
