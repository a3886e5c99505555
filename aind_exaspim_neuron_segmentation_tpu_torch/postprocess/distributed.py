"""Multi-process (multi-host) streaming affinity -> segmentation.

Distributes :func:`.streaming.segment_streaming` -- the e2e-dominating
stage (reference inference.py:196-237 semantics) -- over the contiguous
Z ranges of multiple processes, so the postprocess scales across hosts
exactly like ``parallel.predict_sharded`` does for the forward (rank
and world from ``torch.distributed``; the host payloads ride a TCP hub on
rank 0):

1. every rank runs pass 1 (device pre-digest + slab watershed +
   in-range piece stitching) on its OWN Z range via the native
   streaming engine in distributed mode (``streamseg.cpp``), exporting
   a per-local-root piece table plus one boundary plane of provisional
   root ids / plan bytes per cut -- the identical single-plane contract
   the engine already uses between slabs;
2. rank 0 unites pieces across the cuts (piece-granular, pure numpy
   over the boundary planes), numbers watershed fragments GLOBALLY by
   first foreground appearance in scan order (per-rank scan indices are
   globally offset and Z ranges are disjoint, so the order equals the
   single-process scan), and scatters each rank its root -> fragment
   lut together with its successor's first-plane fragment ids;
3. every rank re-streams its slabs to build its LOCAL RAG in scan
   order (the cut's outgoing z-edges use the successor plane from step
   2) and ships the serialized RAG to rank 0, which routes each edge
   record -- IN RANK ORDER, i.e. global scan order -- to the rank that
   owns its RAG connected component (components assigned greedily by
   edge load; rank 0 never rebuilds the global RAG, only scans
   endpoints -- ``exa_ragroute_*`` in streamseg.cpp);
4. every rank runs the shared merge loop over ITS components (the same
   ``rag.hpp`` code, fragment ids remapped to a dense local range) and
   returns the executed (keep, drop) unions; rank 0 composes them into
   the replay forest, applies the min-size filter + renumber
   (``compose_lut``), broadcasts the fragment -> label lut, and every
   rank relabels + writes its own Z rows
   (:class:`..io.zarr_lite.ZarrPlaneWriter` -- process-disjoint chunk
   keys, no coordination). Components are independent serial programs
   (run_merge contract), per-component event prefixes are invariant to
   which process runs them, and composition is order-independent, so
   the merge -- the one previously rank-0-serial stage -- now scales
   with ranks without changing a bit of output.

Output is BIT-IDENTICAL to single-process ``segment_streaming`` for
any rank count, and to the JAX package's distributed protocol (pinned by
tests/test_torch_distributed.py, virtual ranks and two real gloo
processes).
"""

import os
import pickle
import shutil
import socket
import struct
import sys
import tempfile
import time
import zipfile

import numpy as np
import torch.distributed as dist

from aind_exaspim_neuron_segmentation_tpu_torch import native
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import (
    ZarrPlaneWriter,
    open_zarr,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops.predigest import (
    default_slab_planes,
    predigest_slabs,
)
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess.skeleton import (
    _merge_pieces,
    _params_array,
    bbox_scan,
    crop_pass,
)
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess.streaming import (
    _SlabFile,
)

_NOFG = np.uint64(0xFFFFFFFFFFFFFFFF)


def _world():
    """(world size, rank) of the job; (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def partition_z(depth, n_ranks):
    """Contiguous balanced Z ranges: ``n_ranks`` (lo, hi) pairs."""
    if n_ranks <= 0 or depth < n_ranks:
        raise ValueError(
            f"cannot partition {depth} planes over {n_ranks} ranks"
        )
    base, extra = divmod(depth, n_ranks)
    bounds, lo = [], 0
    for r in range(n_ranks):
        hi = lo + base + (1 if r < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


class _RankWorker:
    """One rank's three passes over its local Z range.

    ``affinities`` is the GLOBAL lazy handle -- either a float
    (3, D, H, W) store or a ``(plan, qaff)`` digest pair (the same
    contract as :func:`..streaming.segment_streaming`); the worker
    slices only its own planes. The protocol calls ``pass1`` ->
    ``pass2`` -> ``pass3`` with rank 0's replies in between. Float
    slabs are digested on ``device`` (default ``cuda``).
    """

    def __init__(self, affinities, z_range, *, aff_threshold_low=0.1,
                 aff_threshold_high=0.9999, tmp_dir=None,
                 slab_planes=None, device=None):
        self.digest_pair = isinstance(affinities, (tuple, list))
        if self.digest_pair:
            self.plan_h, self.qaff_h = affinities
            if (aff_threshold_low, aff_threshold_high) != (0.1, 0.9999):
                raise ValueError(
                    "aff thresholds are baked into the plan bytes at "
                    "digest time; re-digest for non-defaults"
                )
            if self.plan_h.ndim != 3 or self.qaff_h.shape != (
                (3,) + tuple(self.plan_h.shape)
            ):
                # same fail-fast contract as segment_streaming
                raise ValueError(
                    f"digest pair shapes {self.plan_h.shape} / "
                    f"{self.qaff_h.shape} do not match"
                )
            d, h, w = self.plan_h.shape
        else:
            if affinities.ndim != 4 or affinities.shape[0] != 3:
                raise ValueError(
                    f"expected (3, D, H, W) handle, got {affinities.shape}"
                )
            self.aff_h = affinities
            _, d, h, w = affinities.shape
        if aff_threshold_low > aff_threshold_high:
            raise ValueError(
                "streaming segmentation requires aff_threshold_low <= "
                "aff_threshold_high"
            )
        self.low, self.high = aff_threshold_low, aff_threshold_high
        self.dims = (d, h, w)
        self.z0, self.z1 = z_range
        self.device = device
        nz = self.z1 - self.z0
        if slab_planes is None:
            slab_planes = default_slab_planes(h, w)
        self.slab_planes = slab_planes
        self.bounds = [
            (lo, min(lo + slab_planes, nz))
            for lo in range(0, nz, slab_planes)
        ]
        self.work = tempfile.mkdtemp(prefix="exa_distseg_", dir=tmp_dir)
        self.frag_sp = _SlabFile(os.path.join(self.work, "frag.u32"))
        self.qaff_sp = None
        self.seg = native.StreamSegmenter((nz, h, w))
        self.seg.set_distributed(self.z0)

    def pass1(self):
        """Local watershed + piece export (see StreamSegmenter)."""
        d, h, w = self.dims
        if self.digest_pair:
            for lo, hi in self.bounds:
                self.frag_sp.write_slab(self.seg.feed(np.asarray(
                    self.plan_h[self.z0 + lo: self.z0 + hi],
                    dtype=np.uint8,
                )))
        else:
            # digest on the device; the plane at z0 - 1 is the first
            # slab's previous plane (predigest_slabs)
            self.qaff_sp = _SlabFile(os.path.join(self.work, "qaff.u8"))
            for _, _, plan, qaff in predigest_slabs(
                self.aff_h, self.low, self.high, self.slab_planes,
                self.device, z_lo=self.z0, z_hi=self.z1,
            ):
                self.frag_sp.write_slab(self.seg.feed(plan.cpu().numpy()))
                self.qaff_sp.write_slab(qaff.movedim(0, 1).cpu().numpy())
        return self.seg.local_done()

    def pass2(self, ws_of_root, n_fragments, next_first_ws):
        """Local RAG build in scan order; returns the serialized RAG."""
        _, h, w = self.dims
        self.seg.set_ws(ws_of_root, n_fragments)
        for i, (lo, hi) in enumerate(self.bounds):
            nz = hi - lo
            if self.qaff_sp is not None:
                q_slab = self.qaff_sp.read_slab(i, (nz, 3, h, w), np.uint8)
            else:
                q_slab = np.moveaxis(np.asarray(
                    self.qaff_h[:, self.z0 + lo: self.z0 + hi],
                    dtype=np.uint8,
                ), 0, 1)
            self.seg.rag_feed(
                self.frag_sp.read_slab(i, (nz, h, w), np.uint32), q_slab
            )
        self.seg.rag_flush(next_first_ws)
        if self.qaff_sp is not None:
            self.qaff_sp.close()
            self.qaff_sp = None
        return self.seg.rag_export()

    def pass3(self, lut_ws, n_segments, out_path=None):
        """Relabel this rank's rows; write to ``out_path`` or return
        ``(z0, labels_local)``."""
        _, h, w = self.dims
        self.seg.set_lut(lut_ws, n_segments)
        if out_path is not None:
            writer = ZarrPlaneWriter(out_path, self.dims, np.uint32)
            for i, (lo, hi) in enumerate(self.bounds):
                writer.write_planes(self.z0 + lo, self.seg.map(
                    self.frag_sp.read_slab(i, (hi - lo, h, w), np.uint32)
                ))
            self.close()
            return None
        out = np.empty((self.z1 - self.z0, h, w), np.uint32)
        for i, (lo, hi) in enumerate(self.bounds):
            out[lo:hi] = self.seg.map(
                self.frag_sp.read_slab(i, (hi - lo, h, w), np.uint32)
            )
        self.close()
        return self.z0, out

    def close(self):
        """Free the native engine and delete the spool directory."""
        self.seg.close()
        self.frag_sp.close()
        if self.qaff_sp is not None:
            self.qaff_sp.close()
        shutil.rmtree(self.work, ignore_errors=True)


def _hub_stitch(exports):
    """Rank 0: cross-cut piece unification + global fragment numbering.

    ``exports[r]`` is rank r's ``local_done()`` tuple. Returns
    ``(ws_per_rank, n_fragments, frag_fg, next_ws_per_rank)`` where
    ``ws_per_rank[r]`` maps rank r's local root enum indices to global
    fragment ids (0 = dropped) and ``next_ws_per_rank[r]`` is the
    successor's first-plane fragment ids (None for the last rank).

    The stitch unions mirror streamseg.cpp's per-slab stitching at
    piece granularity: a cut union exists where the predecessor's last
    plane carries a +z union flag or a +z steepest direction, or the
    successor's first plane points -z; background endpoints are skipped
    (exact under the low <= high precondition the entry points enforce -- see
    the capture note in streamseg.cpp).
    """
    n = len(exports)
    counts = [len(e[0]) for e in exports]
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    total = int(offs[-1])
    parent = np.arange(total, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    involved = []
    for r in range(n - 1):
        last_root, last_plan = exports[r][4], exports[r][5]
        first_root, first_plan = exports[r + 1][2], exports[r + 1][3]
        src = ((last_plan & 1) != 0) | ((last_plan >> 3) == 1)
        tgt = (first_plan >> 3) == 4
        mask = (src | tgt) & (last_root != 0) & (first_root != 0)
        a = offs[r] + last_root[mask].astype(np.int64) - 1
        b = offs[r + 1] + first_root[mask].astype(np.int64) - 1
        pairs = np.unique(np.stack([a, b], axis=1), axis=0)
        for pa, pb in pairs:
            ra, rb = find(pa), find(pb)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)
        involved.append(a)
        involved.append(b)

    first_fg = np.concatenate([e[0] for e in exports]) if total else (
        np.empty(0, np.uint64)
    )
    fg_cnt = np.concatenate([e[1] for e in exports]) if total else (
        np.empty(0, np.uint64)
    )
    min_fg = first_fg.copy()
    cnt = fg_cnt.copy()
    if involved:
        nodes = np.unique(np.concatenate(involved))
        roots = np.array([find(int(x)) for x in nodes], np.int64)
        moved = nodes[roots != nodes]
        moved_roots = roots[roots != nodes]
        np.minimum.at(min_fg, moved_roots, first_fg[moved])
        np.add.at(cnt, moved_roots, fg_cnt[moved])
        root_of = np.arange(total, dtype=np.int64)
        root_of[nodes] = roots
    else:
        root_of = np.arange(total, dtype=np.int64)

    is_root = root_of == np.arange(total)
    fg_roots = np.nonzero(is_root & (min_fg != _NOFG))[0]
    # First-foreground scan indices are globally unique (disjoint Z
    # ranges), so this order IS the single-process numbering.
    order = np.argsort(min_fg[fg_roots], kind="stable")
    fg_roots = fg_roots[order]
    k = len(fg_roots)
    ws_of_node = np.zeros(total, np.uint32)
    ws_of_node[fg_roots] = np.arange(1, k + 1, dtype=np.uint32)
    ws_of_node = ws_of_node[root_of]
    frag_fg = np.zeros(k + 1, np.uint64)
    frag_fg[1:] = cnt[fg_roots]

    ws_per_rank = [
        ws_of_node[offs[r]: offs[r + 1]] for r in range(n)
    ]
    next_ws = []
    for r in range(n - 1):
        first_root = exports[r + 1][2]
        nw = np.zeros(first_root.size, np.uint32)
        nz = first_root != 0
        nw[nz] = ws_per_rank[r + 1][first_root[nz].astype(np.int64) - 1]
        next_ws.append(nw)
    next_ws.append(None)
    return ws_per_rank, k, frag_fg, next_ws


def segment_streaming_virtual(
    affinities, n_ranks, agglomeration_thresholds=(0.6, 0.8, 0.9),
    min_segment_size=100, aff_threshold_low=0.1,
    aff_threshold_high=0.9999, quantile_pct=85, out_path=None,
    tmp_dir=None, slab_planes=None, device=None,
):
    """The full distributed protocol with ``n_ranks`` VIRTUAL ranks in
    one process -- the rank algorithm without the transport, used by
    the bit-parity tests. Returns the assembled dense labels (or the
    lazy ``out_path`` store). Float slabs are digested on ``device``.
    """
    digest_pair = isinstance(affinities, (tuple, list))
    d = affinities[0].shape[0] if digest_pair else affinities.shape[1]
    th = list(agglomeration_thresholds)
    if not th or any(b < a for a, b in zip(th, th[1:])):
        raise ValueError("thresholds must be non-empty and ascending")
    workers = [
        _RankWorker(
            affinities, zr, aff_threshold_low=aff_threshold_low,
            aff_threshold_high=aff_threshold_high, tmp_dir=tmp_dir,
            slab_planes=slab_planes, device=device,
        )
        for zr in partition_z(d, n_ranks)
    ]
    exports = [w.pass1() for w in workers]
    ws_per_rank, k, frag_fg, next_ws = _hub_stitch(exports)
    parts = [
        w.pass2(ws_per_rank[r], k, next_ws[r])
        for r, w in enumerate(workers)
    ]
    # Component-partitioned merge, exactly as the sharded protocol runs
    # it (each virtual rank merges its own components).
    routed = native.route_rag_parts(parts, k, n_ranks)
    del parts
    pairs = [
        native.merge_rag_local(b, k, th, quantile_pct=quantile_pct)
        for b in routed
    ]
    lut_ws, n_segments = native.compose_rag_lut(
        k, frag_fg, pairs, min_segment_size=min_segment_size,
    )
    if out_path is not None:
        for w in workers:
            w.pass3(lut_ws, n_segments, out_path)
        return open_zarr(out_path)
    blocks = [w.pass3(lut_ws, n_segments) for w in workers]
    h, w_ = workers[0].dims[1:]
    out = np.empty((d, h, w_), np.uint32)
    for z0, block in blocks:
        out[z0: z0 + block.shape[0]] = block
    return out


class _TcpComm:
    """Minimal hub-and-spoke transport: rank 0 accepts one connection
    per peer; ``gather`` / ``scatter`` / ``broadcast`` move pickled
    payloads (trusted peers -- the ranks of one job)."""

    def __init__(self, rank, n_ranks, address, server=None):
        self.rank, self.n = rank, n_ranks
        # Wire accounting (pickled payload bytes, headers excluded) so
        # the protocol cost is a measurable number (``stats_out``).
        self.bytes_sent = 0
        self.bytes_recv = 0
        self._socks = {}
        if rank == 0:
            if server is not None:
                # Rendezvous handed over its live listening socket:
                # the port stays bound from reservation through accept
                # (no close-then-rebind race with other processes on
                # the host).
                srv = server
            else:
                host, port = address.rsplit(":", 1)
                srv = socket.socket()
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                srv.bind((host or "0.0.0.0", int(port)))
            srv.listen(n_ranks)
            # Symmetric to the peers' 120 s connect deadline below: a
            # peer that never launches must not wedge rank 0 in accept.
            srv.settimeout(120)
            for _ in range(n_ranks - 1):
                conn, _addr = srv.accept()
                conn.settimeout(None)
                peer = struct.unpack("<q", self._recv_n(conn, 8))[0]
                self._socks[peer] = conn
            srv.close()
        else:
            host, port = address.rsplit(":", 1)
            deadline = time.time() + 120
            while True:
                s = socket.socket()
                try:
                    s.connect((host, int(port)))
                    break
                except OSError:
                    s.close()
                    if time.time() > deadline:
                        raise
                    time.sleep(0.1)
            s.sendall(struct.pack("<q", rank))
            self._socks[0] = s
        # Opt-in liveness bound: a wedged-but-alive peer (process up,
        # collective never reached) blocks recv forever by default --
        # legitimate, since a rank's compute pass between messages can
        # take unbounded wall time. EXA_HUB_TIMEOUT_S=N raises
        # socket.timeout after N idle seconds instead, for deployments
        # that prefer fail-fast over patience.
        hub_timeout = float(os.environ.get("EXA_HUB_TIMEOUT_S", "0") or 0)
        if hub_timeout > 0:
            for sock in self._socks.values():
                sock.settimeout(hub_timeout)

    @staticmethod
    def _recv_n(sock, n):
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed during transfer")
            buf.extend(chunk)
        return bytes(buf)

    def _send(self, peer, obj):
        payload = pickle.dumps(obj, protocol=4)
        self.bytes_sent += len(payload)
        self._socks[peer].sendall(
            struct.pack("<q", len(payload)) + payload
        )

    def _recv(self, peer):
        sock = self._socks[peer]
        (size,) = struct.unpack("<q", self._recv_n(sock, 8))
        self.bytes_recv += size
        return pickle.loads(self._recv_n(sock, size))

    def gather(self, obj):
        """Rank 0 returns [rank0, rank1, ...]; peers return None."""
        if self.rank == 0:
            return [obj] + [self._recv(r) for r in range(1, self.n)]
        self._send(0, obj)
        return None

    def scatter(self, objs):
        """Rank 0 sends objs[r] to each rank; every rank returns its
        own entry."""
        if self.rank == 0:
            for r in range(1, self.n):
                self._send(r, objs[r])
            return objs[0]
        return self._recv(0)

    def broadcast(self, obj):
        """Rank 0's object, everywhere."""
        if self.rank == 0:
            for r in range(1, self.n):
                self._send(r, obj)
            return obj
        return self._recv(0)

    def close(self):
        """Close all peer sockets."""
        for s in self._socks.values():
            s.close()


def _rendezvous_address(port=0):
    """Agree on rank 0's host:port through ``torch.distributed`` (one
    ``broadcast_object_list`` of the address string).

    Returns ``(addr, server)``: on rank 0 ``server`` is the LIVE
    listening socket bound to that port -- handing it straight to
    :class:`_TcpComm` keeps the port held from reservation through
    accept (a close-then-rebind would race other processes on a busy
    host); peers get ``server=None``.
    """
    srv = None
    if dist.get_rank() == 0:
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", port))
        port = srv.getsockname()[1]
        host = os.environ.get("EXA_DIST_HOST") or socket.gethostbyname(
            socket.gethostname()
        )
        addr = f"{host}:{port}"
    else:
        addr = ""
    box = [addr]
    dist.broadcast_object_list(box, src=0)
    return box[0], srv


def _connect_hub(rank, n, address=None):
    """Hub transport for one job's ranks, with the wire preconditions.

    The pass-1 plan bytes and serialized RAG parts cross ranks in raw
    host layout (streamseg.cpp documents the contract as little-endian,
    asserted here) -- refuse anything else up front rather than
    deserializing garbage on rank 0.
    """
    if sys.byteorder != "little":
        raise RuntimeError(
            "distributed postprocess requires little-endian hosts: the "
            "native RAG/plan wire format is raw little-endian host "
            "layout (see native/src/streamseg.cpp)"
        )
    if address:
        return _TcpComm(rank, n, address)
    addr, srv = _rendezvous_address()
    return _TcpComm(rank, n, addr, server=srv)


def segment_streaming_sharded(
    affinities, agglomeration_thresholds=(0.6, 0.8, 0.9),
    min_segment_size=100, aff_threshold_low=0.1,
    aff_threshold_high=0.9999, quantile_pct=85, out_path=None,
    tmp_dir=None, slab_planes=None, verbose=False, address=None,
    stats_out=None, device=None,
):
    """Multi-process streaming segmentation over ``torch.distributed``.

    Call from EVERY process of the job
    (``parallel.initialize_distributed``) with the same arguments (same
    contract as ``parallel.predict_sharded``); without a process group
    it runs as one process. The global Z range partitions over the
    job's ranks; the host-side piece/RAG exchange rides a TCP hub on
    rank 0 whose address is agreed through ``torch.distributed``
    (override with ``address='host:port'`` / EXA_DIST_HOST when rank 0's
    hostname is not peer-resolvable). Float affinities are digested on
    ``device`` (default ``cuda``). The merge loop is
    component-partitioned across ALL ranks (module docstring step 4) --
    no stage of the pipeline runs on a single host.

    ``out_path``: every process writes its own Z rows into the shared
    store (plane-deep chunks, disjoint keys) and the opened lazy handle
    is returned everywhere. Without it, each process returns
    ``(z0, labels_local)`` -- its own rows only.

    ``stats_out``: optional dict; filled with this rank's per-pass
    wall-clock seconds and protocol byte counts, plus (rank 0 only)
    ``"ranks"`` -- the per-rank stat dicts of the whole job -- so
    transport and compute are separately measurable numbers. The
    single-process fast path fills the same fields with zero hub
    bytes, except that its merge runs the dense in-process loop
    (``merge_s`` instead of the routed path's ``route_s`` /
    ``merge_local_s`` / ``compose_s`` -- no routing happens, so none
    is reported).

    Labels are bit-identical to single-process
    :func:`..streaming.segment_streaming` for any process count.
    """
    n, rank = _world()
    th = list(agglomeration_thresholds)
    if not th or any(b < a for a, b in zip(th, th[1:])):
        raise ValueError("thresholds must be non-empty and ascending")
    t0 = time.time()
    stats = {"rank": rank}

    def stamp(msg):
        if verbose:
            print(
                f"[segment_sharded p{rank} {time.time() - t0:7.0f}s] "
                f"{msg}", file=sys.stderr, flush=True,
            )

    digest_pair = isinstance(affinities, (tuple, list))
    d = affinities[0].shape[0] if digest_pair else affinities.shape[1]
    worker = _RankWorker(
        affinities, partition_z(d, n)[rank],
        aff_threshold_low=aff_threshold_low,
        aff_threshold_high=aff_threshold_high, tmp_dir=tmp_dir,
        slab_planes=slab_planes, device=device,
    )
    if n == 1:
        t = time.time()
        exports = [worker.pass1()]
        stats["pass1_s"] = round(time.time() - t, 3)
        t = time.time()
        ws_per_rank, k, frag_fg, next_ws = _hub_stitch(exports)
        stats["stitch_s"] = round(time.time() - t, 3)
        t = time.time()
        parts = [worker.pass2(ws_per_rank[0], k, next_ws[0])]
        stats["rag_build_s"] = round(time.time() - t, 3)
        stats["rag_part_bytes"] = len(parts[0])
        t = time.time()
        lut_ws, n_segments = native.merge_rag_parts(
            parts, k, frag_fg, th, quantile_pct=quantile_pct,
            min_segment_size=min_segment_size,
        )
        stats["merge_s"] = round(time.time() - t, 3)
        t = time.time()
        result = worker.pass3(lut_ws, n_segments, out_path)
        stats["relabel_s"] = round(time.time() - t, 3)
        stats["bytes_sent"] = stats["bytes_recv"] = 0
        if stats_out is not None:
            stats_out.update(stats)
            stats_out["ranks"] = [dict(stats)]
    else:
        comm = _connect_hub(rank, n, address)
        try:
            t = time.time()
            export = worker.pass1()
            stats["pass1_s"] = round(time.time() - t, 3)
            exports = comm.gather(export)
            stamp("pass 1 done")
            if rank == 0:
                t = time.time()
                ws_per_rank, k, frag_fg, next_ws = _hub_stitch(exports)
                del exports
                stats["stitch_s"] = round(time.time() - t, 3)
                reply = [
                    (ws_per_rank[r], k, next_ws[r]) for r in range(n)
                ]
            else:
                reply = None
            ws, k, nw = comm.scatter(reply)
            stamp(f"stitch done (K={k})")
            t = time.time()
            part = worker.pass2(ws, k, nw)
            stats["rag_build_s"] = round(time.time() - t, 3)
            stats["rag_part_bytes"] = len(part)
            parts = comm.gather(part)
            del part
            stamp("RAG build done")
            # Component-partitioned merge: rank 0 routes edge records
            # to their components' owner ranks (endpoint scan only --
            # the global RAG is never rebuilt), every rank merges its
            # own components, rank 0 composes the union events.
            if rank == 0:
                t = time.time()
                routed = native.route_rag_parts(parts, k, n)
                del parts
                stats["route_s"] = round(time.time() - t, 3)
            else:
                routed = None
            my_edges = comm.scatter(routed)
            del routed
            stats["routed_bytes"] = len(my_edges)
            t = time.time()
            pairs = native.merge_rag_local(
                my_edges, k, th, quantile_pct=quantile_pct
            )
            del my_edges
            stats["merge_local_s"] = round(time.time() - t, 3)
            stats["merge_pairs"] = int(len(pairs))
            stamp(f"local merge done ({len(pairs)} unions)")
            all_pairs = comm.gather(pairs)
            if rank == 0:
                t = time.time()
                lut_ws, n_segments = native.compose_rag_lut(
                    k, frag_fg, all_pairs,
                    min_segment_size=min_segment_size,
                )
                del all_pairs
                stats["compose_s"] = round(time.time() - t, 3)
            else:
                lut_ws = n_segments = None
            lut_ws, n_segments = comm.broadcast((lut_ws, n_segments))
            stamp(f"merge done (n_segments={n_segments})")
            t = time.time()
            result = worker.pass3(lut_ws, n_segments, out_path)
            stats["relabel_s"] = round(time.time() - t, 3)
            # Writers must all finish before anyone reads the store;
            # the barrier carries each rank's stats to rank 0.
            stats["bytes_sent"] = comm.bytes_sent
            stats["bytes_recv"] = comm.bytes_recv
            rank_stats = comm.gather(stats)
            comm.broadcast(True)
            stamp("relabel + write done")
            if stats_out is not None:
                stats_out.update(stats)
                if rank == 0:
                    stats_out["ranks"] = rank_stats
        finally:
            comm.close()
    if out_path is not None:
        return open_zarr(out_path)
    return result


def _partition_z_skeleton(depth, n_ranks):
    """``partition_z``, but ranks beyond the plane count take EMPTY
    (lo == lo) ranges instead of raising: the skeleton work is
    label-partitioned, so a shallow volume on a wide job is harmless
    (the empty bbox scan contributes a sentinel partial)."""
    if n_ranks <= depth:
        return partition_z(depth, n_ranks)
    return partition_z(depth, depth) + [(depth, depth)] * (n_ranks - depth)


def _merge_bbox_partials(partials):
    """Merge per-rank (bbox, counts, gmin, gmax) partials from disjoint
    Z ranges: pad to the widest label table, elementwise min/max the
    bbox columns, sum the counts. Empty-range partials carry
    ``gmin is None`` and are skipped in the extrema."""
    n = max(len(c) for _, c, _, _ in partials)
    bbox = np.empty((n, 6), np.int64)
    bbox[:, 0::2] = np.iinfo(np.int64).max
    bbox[:, 1::2] = -1
    counts = np.zeros(n, np.int64)
    gmin = min(g for _, _, g, _ in partials if g is not None)
    gmax = max(g for _, _, _, g in partials if g is not None)
    for b, c, _, _ in partials:
        k = len(c)
        np.minimum(bbox[:k, 0::2], b[:, 0::2], out=bbox[:k, 0::2])
        np.maximum(bbox[:k, 1::2], b[:, 1::2], out=bbox[:k, 1::2])
        counts[:k] += c
    return bbox, counts, gmin, gmax


def _partition_labels(counts, n_ranks):
    """Deterministic label -> rank assignment balancing voxel load:
    labels in descending count order (ties by id) greedily go to the
    least-loaded rank. Returns a list of per-rank label lists (each
    sorted ascending, so piece iteration order is scan-stable)."""
    labs = sorted(
        (lab for lab in range(1, len(counts)) if counts[lab]),
        key=lambda lab: (-int(counts[lab]), lab),
    )
    load = [0] * n_ranks
    out = [[] for _ in range(n_ranks)]
    for lab in labs:
        r = min(range(n_ranks), key=lambda i: (load[i], i))
        load[r] += int(counts[lab])
        out[r].append(lab)
    for part in out:
        part.sort()
    return out


def _skeleton_plan(partials, n_ranks, kw):
    """Shared rank-0 planning for the sharded/virtual skeletonizers:
    merge bbox partials, build params, partition labels."""
    bbox, counts, gmin, gmax = _merge_bbox_partials(partials)
    params = _params_array(
        kw["scale"], kw["const"], kw["pdrf_exponent"], kw["pdrf_scale"],
        kw["soma_detection_threshold"], kw["soma_acceptance_threshold"],
        kw["soma_invalidation_scale"], kw["soma_invalidation_const"],
        kw["anisotropy"], kw["parallel"], black_border=(gmin == gmax),
    )
    return [
        (part, bbox, params) for part in _partition_labels(counts, n_ranks)
    ]


_SKEL_DEFAULTS = dict(
    scale=1.25, const=450, pdrf_exponent=4, pdrf_scale=100000,
    soma_detection_threshold=1000, soma_acceptance_threshold=3500,
    soma_invalidation_scale=1.0, soma_invalidation_const=300,
    anisotropy=(1.0, 1.0, 1.0), parallel=1,
)


def skeletonize_virtual(labels, n_ranks, fix_borders=True,
                        fill_holes=True, slab_planes=64, **teasar_kw):
    """:func:`skeletonize_sharded` with ``n_ranks`` VIRTUAL ranks in one
    process -- the rank algorithm without the transport, used by the
    bit-parity tests."""
    kw = {**_SKEL_DEFAULTS, **teasar_kw}
    d = labels.shape[0]
    partials = [
        bbox_scan(labels, lo, hi, slab_planes)
        for lo, hi in _partition_z_skeleton(d, n_ranks)
    ]
    pieces = {}
    for labs, bbox, params in _skeleton_plan(partials, n_ranks, kw):
        pieces.update(
            crop_pass(labels, labs, bbox, params, fix_borders, fill_holes)
        )
    return _merge_pieces(pieces)


def skeletonize_sharded(labels, fix_borders=True, fill_holes=True,
                        slab_planes=64, address=None, verbose=False,
                        zip_path=None, broadcast=False, stats_out=None,
                        **teasar_kw):
    """Multi-process TEASAR skeletonization over ``torch.distributed``.

    Call from EVERY process of the job with the same arguments (the
    ``segment_streaming_sharded`` contract; same TEASAR parameter surface as
    :func:`..skeleton.skeletonize_lazy`, reference inference.py:272-291
    for the kimimaro defaults). Two distributed passes over the (lazy)
    label store:

    1. every rank slab-scans its own contiguous Z range for per-label
       bboxes (:func:`..skeleton.bbox_scan`); rank 0 merges the
       partials (elementwise min/max + count sums);
    2. labels are partitioned across ranks by descending voxel load
       (deterministic) and each rank skeletonizes its labels from
       their 1-voxel-padded bbox crops -- per-label work is isolated,
       so the partition cannot change any skeleton.

    Each process returns the ``{segment_id: Skeleton}`` table of ITS
    OWN labels only (disjoint across ranks; their union is
    bit-identical to single-process ``skeletonize_lazy``, pinned by
    tests) -- at ExaSPIM label counts, materializing every skeleton on
    every rank would be O(all skeletons) memory per host for nothing.

    ``zip_path``: rank 0 additionally assembles the full SWC archive --
    peers ship their labels' SWC texts (never Skeleton objects, never
    other ranks' data) and rank 0 writes ``{id}.swc`` entries in
    ascending id, matching the single-process
    ``skeletons_to_zipped_swcs(skeletonize_lazy(...))`` archive entry
    for entry. This is the ``swc --distributed`` / ``run
    --distributed`` CLI contract.

    ``broadcast=True`` restores the full-dict-everywhere return (every
    rank pays O(all skeletons) memory -- only for callers that truly
    need the complete table on every host).

    ``stats_out``: optional dict; filled with this rank's per-pass
    walls and hub byte counts (rank 0 additionally gets ``"ranks"``).
    """
    kw = {**_SKEL_DEFAULTS, **teasar_kw}
    n, rank = _world()
    if n == 1:
        # Single-process fast path: same passes, no transport -- and
        # the SAME stats_out contract fields as the multi-rank path
        # (per-pass walls, labels_local, n_skeletons, zero hub bytes).
        stats = {"rank": 0}
        t = time.time()
        partial = bbox_scan(labels, 0, labels.shape[0], slab_planes)
        stats["bbox_scan_s"] = round(time.time() - t, 3)
        labs, bbox, params = _skeleton_plan([partial], 1, kw)[0]
        stats["labels_local"] = len(labs)
        t = time.time()
        skeletons = _merge_pieces(
            crop_pass(labels, labs, bbox, params, fix_borders,
                      fill_holes)
        )
        stats["crop_pass_s"] = round(time.time() - t, 3)
        if zip_path is not None:
            t = time.time()
            with zipfile.ZipFile(zip_path, "w") as zf:
                for seg_id in sorted(skeletons):
                    zf.writestr(
                        f"{seg_id}.swc", skeletons[seg_id].to_swc()
                    )
            stats["n_skeletons"] = len(skeletons)
            stats["zip_s"] = round(time.time() - t, 3)
        stats["bytes_sent"] = stats["bytes_recv"] = 0
        if stats_out is not None:
            stats_out.update(stats)
            stats_out["ranks"] = [dict(stats)]
        return skeletons
    t0 = time.time()
    stats = {"rank": rank}

    def stamp(msg):
        if verbose:
            print(
                f"[skeletonize_sharded p{rank} {time.time() - t0:7.0f}s]"
                f" {msg}", file=sys.stderr, flush=True,
            )

    z_lo, z_hi = _partition_z_skeleton(labels.shape[0], n)[rank]
    comm = _connect_hub(rank, n, address)
    try:
        t = time.time()
        partial = bbox_scan(labels, z_lo, z_hi, slab_planes)
        stats["bbox_scan_s"] = round(time.time() - t, 3)
        partials = comm.gather(partial)
        plan = _skeleton_plan(partials, n, kw) if rank == 0 else None
        labs, bbox, params = comm.scatter(plan)
        stats["labels_local"] = len(labs)
        stamp(f"bbox scan + plan done ({len(labs)} labels local)")
        t = time.time()
        local = _merge_pieces(
            crop_pass(labels, labs, bbox, params, fix_borders, fill_holes)
        )
        stats["crop_pass_s"] = round(time.time() - t, 3)
        stamp("crop pass done")
        if zip_path is not None:
            # Rank 0 single-writer zip: peers hand over SWC TEXT for
            # their own labels (compact, write-ready); nothing is ever
            # broadcast back, so peer memory stays at its local table.
            t = time.time()
            texts = comm.gather(
                {seg_id: sk.to_swc() for seg_id, sk in local.items()}
            )
            if rank == 0:
                merged = {}
                for part in texts:
                    merged.update(part)
                del texts
                with zipfile.ZipFile(zip_path, "w") as zf:
                    for seg_id in sorted(merged):
                        zf.writestr(f"{seg_id}.swc", merged[seg_id])
                stats["n_skeletons"] = len(merged)
                del merged
            stats["zip_s"] = round(time.time() - t, 3)
            stamp("zip written")
        if broadcast:
            pieces = comm.gather(local)
            if rank == 0:
                merged = {}
                for p in pieces:
                    merged.update(p)
                local = comm.broadcast(merged)
            else:
                local = comm.broadcast(None)
        stats["bytes_sent"] = comm.bytes_sent
        stats["bytes_recv"] = comm.bytes_recv
        rank_stats = comm.gather(stats)
        comm.broadcast(True)  # archive visible before anyone returns
        if stats_out is not None:
            stats_out.update(stats)
            if rank == 0:
                stats_out["ranks"] = rank_stats
        return local
    finally:
        comm.close()
