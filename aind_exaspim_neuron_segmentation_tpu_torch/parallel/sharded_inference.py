"""Multi-rank sliding-window inference: slab sharding + halo exchange.

The patch grid is distributed over a 1-D rank mesh (Z rows) or a 2-D
one (Z rows x Y rows), one device per rank. Each rank runs the same
accumulate loop as single-device ``predict`` over its own rows
(:func:`..ops.stitch.accumulate_predictions`, so kernel K1 blends on the
card); the trimmed patch outputs that spill past a slab's owned range
(``overlap - 2*trim`` planes per axis, 16 by default) go to the forward
neighbour rank and are added there: one neighbour exchange per sharded
axis, no host-side blending.

2-D corner flow: the Z exchange runs first with strips that include the
Y-tail columns, then the Y exchange forwards strips covering the full
local Z extent (owned + received head + unsent tail). A contribution
bound for the diagonal neighbour therefore arrives exactly once, via
Z-then-Y; the Y-then-Z copy lands in a Z-tail its holder discards
(only last-Z ranks keep Z tails, and they have no Z neighbour that
could double-deliver).

Feature parity with single-device ``predict``:

* **Lazy inputs stream per rank** -- each rank slices its own slab from
  the (zarr/N5) source through a precomputed pad index map; at most one
  slab is ever dense on a host.
* **Normalization runs on the device**: brightness clip at slab load,
  then exact global percentiles over the mesh by masked radix order
  statistics (:func:`.stats.order_stats_sharded`, one integer
  histogram ``all_reduce`` per round) with ``np.percentile``'s float64
  interpolation on the fetched values (:func:`.stats.lerp_plan`) -- no
  host pass over the volume. The slab is then normalized in float64 and
  rounded to float32, as the host normalize does, so the model sees the
  input bits ``predict`` gives it.
* **Gaussian blend** (``blend_mode='gaussian'``) matches ``predict``.
* **Streaming output**: with ``out_path`` each rank writes its own rows
  into a shared Zarr store (disjoint chunk keys); host memory stays
  O(one row).

Bit-compatibility: identical patch set, same per-patch math, and on a
1-D mesh the same float32 addition order as ``predict``: the rank that
receives a Z strip starts its head planes from it and adds its own
patches' shares there again in patch order, so a 1-D mesh gives
``predict``'s bits. On a 2-D mesh the Y strips add to sums made in
another order (<= 1e-6, tests/test_torch_parallel.py).
"""

import contextlib
import math
import warnings

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (
    DEFAULT_PERCENTILES,
    streaming_percentile,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
    patch_grid_ranges,
)
from aind_exaspim_neuron_segmentation_tpu_torch.inference import (
    ModelRunner,
    _slab_plan,
    _Volume5DView,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io import read
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import (
    ZarrAppendWriter,
    ZarrPlaneWriter,
    write_zarr,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import stitch
from aind_exaspim_neuron_segmentation_tpu_torch.ops.predigest import (
    predigest_shard,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops.scatter import (
    scatter_batch,
)
from aind_exaspim_neuron_segmentation_tpu_torch.parallel import stats
from aind_exaspim_neuron_segmentation_tpu_torch.parallel.mesh import (
    barrier,
    make_mesh,
    shift_forward,
)


class _AxisPlan:
    """Row partitioning of one sharded spatial axis over n mesh slots."""

    def __init__(self, starts, patch, overlap, trim, n_dev):
        self.starts = list(starts)
        self.patch = patch
        self.stride = patch - overlap
        self.spill = max(overlap - 2 * trim, 0)
        self.n_dev = n_dev
        rpd = math.ceil(len(self.starts) / n_dev)
        # Single-hop exchange: a rank's spill must land inside its
        # immediate neighbour's owned extent.
        rpd = max(rpd, math.ceil(self.spill / max(self.stride, 1)))
        self.rpd = rpd
        self.slab = (rpd - 1) * self.stride + patch
        self.own = rpd * self.stride
        if self.spill > self.own:
            raise ValueError(
                f"spill {self.spill} exceeds owned extent {self.own}: "
                "overlap too large relative to stride for single-hop "
                "halo exchange"
            )

    def padded_len(self, dim):
        """Axis length covering every slab gather (grid + deep padding)."""
        return max((self.n_dev * self.rpd - 1) * self.stride + self.patch,
                   dim)


def _axis_pad_map(dim, patch, starts, total_len):
    """Index map padded-position -> source plane for one axis.

    Replicates :func:`..ops.stitch.reflect_pad_to_grid` (reflection
    anchored at the LAST patch's tail segment, multi-bounce included)
    followed by edge extension out to ``total_len`` -- as an index map,
    so lazy sources can be sliced per rank instead of padded densely.
    """
    idx = np.arange(dim)
    pad = max(starts[-1] + patch - dim, 0)
    if pad > 0:
        tail = idx[starts[-1]:]
        ext = np.pad(tail, (0, pad), mode="reflect")
        idx = np.concatenate([idx, ext[dim - starts[-1]:]])
    if total_len > len(idx):
        idx = np.pad(idx, (0, total_len - len(idx)), mode="edge")
    return idx[:total_len]


def _auto_band_rows(n_rows, nz, stride_z, patch_z, plane_bytes,
                    budget=4 * 1024**3):
    """Largest Z-row count whose per-rank slab + accumulator fit the
    device ``budget`` (input f32 + 3-channel f32 accumulator per plane).

    Returns ``None`` when every row fits in one band (the common case,
    which keeps mesh-order-statistics normalization).
    """
    per_dev_z_budget = budget // max(plane_bytes, 1)
    rpd = max(int((per_dev_z_budget - patch_z) // max(stride_z, 1)), 1)
    rows = rpd * nz
    return None if rows >= n_rows else rows


def _ysplit_chunk_grid(trim, own, dim):
    """(cy, cx) store chunk grid for Y-split multi-rank writes.

    Chunk height must divide every Y shard boundary (``trim + j*own``)
    so the ranks sharing a Z row touch disjoint chunk keys;
    ``gcd(trim, own)`` does (halved down to <=256 for sane objects).
    A degenerate gcd (coprime trim/own -> cy=1) stays CORRECT but
    explodes the store into per-row chunks, so warn with the object
    count and the knobs that fix it.
    """
    g = math.gcd(trim, own) if trim else own
    while g > 256 and g % 2 == 0:
        g //= 2
    if g < 8:
        n_chunks = dim[0] * -(-dim[1] // g) * -(-dim[2] // 256)
        warnings.warn(
            f"Y-split output chunk height gcd(trim={trim}, own={own})"
            f" = {g} is degenerate: the store would need ~{n_chunks} "
            "chunk objects. Pick patch/overlap/trim so the per-rank "
            "Y extent shares a factor >= 8 with trim, use a Z-only "
            "mesh, or pass allow_partial=True.",
            RuntimeWarning, stacklevel=3,
        )
    return (g, min(256, dim[2]))


def _empty_grid(dim, out_channels, affinity_mode, predigest, out_path,
                mesh):
    """An axis shorter than the overlap: no patch runs, the result is
    zeros; with ``out_path`` the mesh's first rank writes the stores."""
    if predigest:
        arrays = (np.zeros(dim, np.uint8), np.zeros((3,) + dim, np.uint8))
        paths = out_path
    else:
        out = np.zeros((out_channels,) + dim, np.float32)
        arrays = (out if affinity_mode else out[0],)
        paths = (out_path,)
    if out_path is None:
        return arrays if predigest else arrays[0]
    if mesh.coords == (0,) * len(mesh.shape):
        for path, arr in zip(paths, arrays):
            write_zarr(path, arr)
    barrier(mesh)
    handles = tuple(read(p) for p in paths)
    return handles if predigest else handles[0]


@torch.inference_mode()
def predict_sharded(
    img,
    model,
    mesh=None,
    affinity_mode=True,
    batch_size=16,
    brightness_clip=1000,
    normalization_percentiles=DEFAULT_PERCENTILES,
    patch_shape=(96, 96, 96),
    overlap=(32, 32, 32),
    trim=8,
    blend_mode="uniform",
    blend_sigma=None,
    out_path=None,
    max_band_rows=None,
    timer=None,
    allow_partial=False,
    predigest=False,
):
    """predict() over a 1-D (Z) or 2-D (Z x Y) rank mesh.

    Every rank of ``mesh`` (default: :func:`.mesh.make_mesh`, every rank
    of the job) calls it with the same arguments; each drives its own
    device (``model``'s, a :class:`~..inference.ModelRunner`). ``img``
    may be a dense array or any lazy chunked reader
    (``io.zarr_lite.LazyArray``); lazy sources are never densified.

    ``out_path`` streams the result into a Zarr store: each rank writes
    its own rows (plane-deep chunks, so disjoint chunk keys), the ranks
    meet at a barrier, and every rank returns the lazy handle.

    ``max_band_rows``: the Z patch rows are processed in bands of at
    most this many rows -- the mesh-wide analogue of ``predict``'s
    ``max_slab_rows``. Default ``None`` auto-sizes: one band whenever
    the per-rank slab + accumulator fit a ~4 GiB device budget (the
    common case), else the largest band that does. Pass ``0`` to force
    a single band regardless. Boundary rows are recomputed by the next
    band, so a device holds one band's slab and accumulator at a time;
    normalization then switches from mesh order statistics to the exact
    host-streaming radix percentile over the source.

    ``allow_partial``: a mesh of more than one rank is a job of several
    processes, and each process holds only its own rows. Without
    ``out_path`` each rank can return only its own fill (zeros
    elsewhere); that call is refused unless ``allow_partial=True``
    makes the contract explicit. ``out_path`` streaming supports 2-D
    meshes too: the store's Y chunk grid is aligned to the shard
    boundaries (``cy = gcd(trim, own)``) so the ranks write disjoint
    chunk keys with no coordination. A mesh of one rank returns the
    whole result.

    ``timer``: optional :class:`..utils.profiling.StageTimer` recording
    wall time per stage (``load_slabs`` / ``normalize`` / ``forward`` /
    ``fetch_assemble``), synchronized with the device.

    ``predigest``: every rank digests its own final blended region on
    its device (:func:`..ops.predigest.predigest_shard`; the
    incoming-edge halos are one extra single-plane exchange per sharded
    axis) and the call returns ``(plan, qaff)`` uint8 arrays for
    ``inference.affinities_to_segmentation`` -- 4 bytes/voxel leave the
    device instead of 12. Requires ``affinity_mode`` and a single band
    (for beyond-device volumes stream float32 to a single ``out_path``
    and give the lazy handle to ``affinities_to_segmentation``, which
    digests slab-wise). With ``out_path=(plan_path, qaff_path)`` the
    digests stream into two u8 Zarr stores and the returned pair is
    lazy handles. Digesting the assembled float output of the same
    sharded run gives the same bytes.
    """

    def _st(name):
        return (timer.stage(name) if timer is not None
                else contextlib.nullcontext())

    lazy = not isinstance(img, (np.ndarray, torch.Tensor, list, tuple))
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    elif not lazy:
        img = np.asarray(img)
    if getattr(img, "ndim", 0) == 5:
        img = _Volume5DView(img) if lazy else img[0, 0]
    if img.ndim != 3:
        raise ValueError(f"expected 3D or 5D input, got shape {img.shape}")

    runner = model if isinstance(model, ModelRunner) else ModelRunner(model)
    out_channels = 3 if affinity_mode else 1
    if runner.output_channels != out_channels:
        raise ValueError(
            f"model has {runner.output_channels} output channels, "
            f"affinity_mode={affinity_mode} needs {out_channels}"
        )
    if predigest:
        if not affinity_mode:
            raise ValueError("predigest=True requires affinity_mode=True")
        if out_path is not None and (
            not isinstance(out_path, (tuple, list)) or len(out_path) != 2
        ):
            raise ValueError(
                "predigest streams TWO stores; pass "
                "out_path=(plan_path, qaff_path) -- or stream f32 with a "
                "single out_path and digest the lazy handle via "
                "affinities_to_segmentation"
            )
    if blend_mode not in ("uniform", "gaussian"):
        raise ValueError(f"unknown blend_mode {blend_mode!r}")
    mesh = mesh or make_mesh()
    axes = mesh.axis_names
    if len(axes) == 1:
        nz, ny = mesh.size, 1
    elif len(axes) == 2:
        nz, ny = mesh.shape
    else:
        raise ValueError(f"expected a 1-D or 2-D mesh, got axes {axes}")
    if mesh.coords is None:
        raise ValueError(f"rank {mesh.rank} is not in {mesh}")
    ci, cj = mesh.coords[0], (mesh.coords[1] if len(axes) == 2 else 0)
    # Each rank is a process: a mesh of several ranks follows the
    # multi-process output contract.
    multiproc = mesh.size > 1
    if multiproc and out_path is None and not allow_partial:
        raise ValueError(
            "multi-rank predict_sharded without out_path returns a "
            "partially-filled array on each rank (only its own rows; "
            "zeros elsewhere). Pass out_path= for a complete store "
            "assembled across ranks, or allow_partial=True to accept the "
            "rank-local fill."
        )

    dim = tuple(int(d) for d in img.shape)
    ranges = patch_grid_ranges(dim, patch_shape, overlap)
    if any(len(r) == 0 for r in ranges):
        return _empty_grid(dim, out_channels, affinity_mode, predigest,
                           out_path, mesh)

    # --- Band plan over Z patch rows -----------------------------------
    # Bands reuse single-device predict's slab planner: each band owns
    # [own_lo, own_hi) of the output and recomputes the previous band's
    # trailing rows whose trimmed output reaches into its range.
    z_starts_all = list(ranges[0])
    n_rows_all = len(z_starts_all)
    # Y partitioning is band-independent; build it first so the band
    # budget can use the PER-RANK Y slab.
    yp = _AxisPlan(ranges[1], patch_shape[1], overlap[1], trim, ny)
    if max_band_rows is None:
        plane_bytes = 4 * (1 + out_channels) * yp.slab * max(
            dim[2], ranges[2][-1] + patch_shape[2]
        )
        max_band_rows = _auto_band_rows(
            n_rows_all, nz, patch_shape[0] - overlap[0], patch_shape[0],
            plane_bytes,
        )
    if not max_band_rows or max_band_rows >= n_rows_all:
        band_plans = [dict(
            rows=list(range(n_rows_all)), own=(0, dim[0]),
            in_range=(z_starts_all[0], z_starts_all[-1] + patch_shape[0]),
        )]
    else:
        band_plans = _slab_plan(
            z_starts_all, patch_shape[0], trim, dim[0], max_band_rows
        )
    banded = len(band_plans) > 1
    if predigest and banded:
        raise ValueError(
            "predigest=True needs a single band (the digest's -z halo "
            "is exchanged between ranks, not across bands); pass "
            "max_band_rows=0 if device memory allows, or stream f32 with "
            "out_path= and digest the lazy handle via "
            "affinities_to_segmentation"
        )
    max_band_nrows = max(len(p["rows"]) for p in band_plans)

    # Geometry is uniform across bands (max_band_nrows rows padded with
    # invalid rows).
    zp = _AxisPlan(
        range(max_band_nrows), patch_shape[0], overlap[0], trim, nz
    )

    # Per-axis pad index maps (grid reflection + deep edge extension on
    # the sharded axes), used to slice each rank's slab from the source
    # without materializing a padded volume.
    z_map_len = max(
        max(
            p["in_range"][0] + (nz * zp.rpd - 1) * zp.stride
            + patch_shape[0]
            for p in band_plans
        ),
        dim[0],
    )
    map_z = _axis_pad_map(dim[0], patch_shape[0], ranges[0], z_map_len)
    map_y = _axis_pad_map(
        dim[1], patch_shape[1], ranges[1], yp.padded_len(dim[1])
    )
    map_x = _axis_pad_map(
        dim[2], patch_shape[2], ranges[2],
        max(ranges[2][-1] + patch_shape[2], dim[2]),
    )
    wp = len(map_x)
    device = runner.device

    def load_slab(in_lo):
        """This rank's (slab_z, slab_y, wp) f32 slab, brightness-clipped,
        on its device."""
        zsel = map_z[in_lo + ci * zp.own: in_lo + ci * zp.own + zp.slab]
        ysel = map_y[cj * yp.own: cj * yp.own + yp.slab]
        z_lo, z_hi = int(zsel.min()), int(zsel.max()) + 1
        y_lo, y_hi = int(ysel.min()), int(ysel.max()) + 1
        block = np.asarray(img[z_lo:z_hi, y_lo:y_hi, :], dtype=np.float32)
        slab = block[np.ix_(zsel - z_lo, ysel - y_lo, map_x)]
        slab = np.minimum(slab, np.float32(brightness_clip))
        return stitch.host_to_device(slab, device)

    # --- Normalization ------------------------------------------------
    # Single band: exact global percentiles on the devices (masked radix
    # order stats summed over the mesh, np.percentile's float64
    # interpolation on the fetched values -- no host pass). Banded: the
    # band slabs never coexist on the devices, so the exact
    # host-streaming radix percentile runs over the source instead.
    first_slab = None
    if banded:
        with _st("normalize"):
            mn, mx = streaming_percentile(
                img, normalization_percentiles,
                transform=lambda b: np.minimum(b, brightness_clip),
            )
    else:
        n_total = int(np.prod(dim))
        ks, q_plan = stats.rank_plan(n_total, normalization_percentiles)
        with _st("load_slabs"):
            first_slab = load_slab(band_plans[0]["in_range"][0])
        with _st("normalize"):
            tz = torch.arange(zp.slab, device=device)
            mz = (((tz < zp.own) | (ci == nz - 1))
                  & (ci * zp.own + tz < dim[0]))
            ty = torch.arange(yp.slab, device=device)
            my = (((ty < yp.own) | (cj == ny - 1))
                  & (cj * yp.own + ty < dim[1]))
            mx_ = torch.arange(wp, device=device) < dim[2]
            mask = (mz[:, None, None] & my[None, :, None]
                    & mx_[None, None, :])
            vals = torch.where(mask, first_slab, torch.inf)
            order_vals = stats.order_stats_sharded(vals, ks, mesh).cpu()
            del vals, mask
        mn, mx = stats.lerp_plan(order_vals.numpy(), q_plan)
    scale = float(mx) - float(mn) + 1e-8

    def normalize(slab):
        # float64 as the host normalize, rounded once to float32
        return ((slab.double() - float(mn)) / scale).clamp_(0.0, 1.0).float()

    # --- Patch starts / masks / blend weights -------------------------
    # Starts are band-local and identical for every band (consecutive
    # grid rows at uniform stride); only validity varies with the band's
    # real row count.
    xs = list(ranges[2])
    starts = np.asarray([
        (rz * zp.stride, ry * yp.stride, x)
        for rz in range(zp.rpd) for ry in range(yp.rpd) for x in xs
    ], np.int32)
    pad_n = (-len(starts)) % batch_size
    starts = np.concatenate([starts, np.repeat(starts[:1], pad_n, 0)])

    def build_valid(n_rows_b):
        valid = [
            1.0 if (ci * zp.rpd + rz < n_rows_b
                    and cj * yp.rpd + ry < len(yp.starts)) else 0.0
            for rz in range(zp.rpd) for ry in range(yp.rpd) for _x in xs
        ]
        return np.asarray(valid + [0.0] * pad_n, np.float32)

    host_windows = windows = None
    if blend_mode == "gaussian":
        host_windows = tuple(
            stitch.gaussian_window(p, trim, blend_sigma or p / 6.0)
            for p in patch_shape
        )
        windows = tuple(
            stitch.host_to_device(w, device) for w in host_windows
        )

    # This rank's weight slices over the kept (own + spill) windows; the
    # global per-axis weight vectors are sliced at each band's offset.
    wz, wy, wx = stitch.separable_weights(
        dim, patch_shape, overlap, trim, windows=host_windows
    )
    wz_ext = np.concatenate([wz, np.zeros(z_map_len + zp.patch, np.float32)])
    wy_ext = np.concatenate([
        wy, np.zeros(ny * yp.own + yp.spill + yp.patch, np.float32)
    ])
    y0 = cj * yp.own + trim
    wy_l = stitch.host_to_device(wy_ext[y0: y0 + yp.own + yp.spill], device)
    wx_l = stitch.host_to_device(
        np.concatenate([wx, np.zeros(wp - len(wx), np.float32)]), device
    )
    keep_z, keep_y = zp.own + zp.spill, yp.own + yp.spill

    def forward_band(slab, in_lo, n_rows_b):
        """(C, keep_z, keep_y, wp) final blended values of this rank's
        slab, or the (4, ...) u8 digest with ``predigest``."""
        valid = build_valid(n_rows_b)
        head = []  # the Z head's share of each patch, in patch order

        def keep_head(i, probs):
            # rows whose cores reach into [0, spill) of the kept region
            s, v = starts[i: i + batch_size], valid[i: i + batch_size] > 0
            for z in sorted(set(s[v & (s[:, 0] < zp.spill), 0].tolist())):
                sel = np.nonzero(v & (s[:, 0] == z))[0]
                host = s[sel] + np.asarray([0, trim, trim], np.int32)
                cut = probs[torch.from_numpy(sel).to(device), :,
                            : zp.spill - z].contiguous()
                head.append((host, cut))

        receives_z = zp.spill > 0 and nz > 1 and ci > 0
        acc = stitch.accumulate_predictions(
            runner.module, normalize(slab), starts, valid,
            patch_shape=tuple(patch_shape), trim=trim,
            batch_size=batch_size, out_channels=out_channels,
            windows=windows, on_batch=keep_head if receives_z else None,
        )
        mine = acc[:, trim: trim + keep_z, trim: trim + keep_y]
        # Phase Z: forward the z-tail, Y-tail columns included. The
        # receiver starts its head from the strip (the earlier rows'
        # sum) and adds its own patches' shares again in patch order,
        # so each voxel sums in predict's order.
        if zp.spill > 0 and nz > 1:
            recv = shift_forward(mine[:, zp.own: keep_z], mesh, 0)
            if recv is not None:
                redo = torch.zeros((out_channels, zp.spill, yp.slab, wp),
                                   dtype=torch.float32, device=device)
                redo[:, :, trim: trim + keep_y] = recv
                for host, cut in head:
                    scatter_batch(redo, cut, stitch.host_to_device(
                        host, device), trim=0, host_starts=host)
                mine[:, : zp.spill] = redo[:, :, trim: trim + keep_y]
        # Phase Y: forward the y-tail over the FULL local z extent.
        if len(axes) == 2 and yp.spill > 0 and ny > 1:
            recv = shift_forward(mine[:, :, yp.own: keep_y], mesh, 1)
            if recv is not None:
                mine[:, :, : yp.spill] += recv
        z0 = in_lo + ci * zp.own + trim
        wz_l = stitch.host_to_device(wz_ext[z0: z0 + keep_z], device)
        blended = stitch.divide_by_weights(mine, wz_l, wy_l, wx_l)
        del acc, mine
        if not predigest:
            return blended
        # One zero plane past the kept region along Z and Y: where the
        # last patch's core ends before the volume does, the first
        # never-covered plane digests its incoming edge from the last
        # covered one (the region past it digests to zeros).
        blended = torch.nn.functional.pad(blended, (0, 0, 0, 1, 0, 1))
        # Incoming-edge halos: each region's first plane needs the
        # predecessor's last OWNED plane of the matching affinity
        # channel (final after the spill phases above). First regions
        # get zeros -- the volume's zero trim margin at z_off-1 / y_off-1.
        prev_z = torch.zeros_like(blended[0, 0])
        if nz > 1:
            recv = shift_forward(blended[0, zp.own - 1], mesh, 0)
            prev_z = prev_z if recv is None else recv
        prev_y = torch.zeros_like(blended[1, :, 0])
        if len(axes) == 2 and ny > 1:
            recv = shift_forward(blended[1, :, yp.own - 1], mesh, 1)
            prev_y = prev_y if recv is None else recv
        plan_b, qaff_b = predigest_shard(
            blended, prev_z, prev_y, z0, y0, dim,
        )
        return torch.cat([plan_b[None], qaff_b], dim=0)

    # --- Output sinks --------------------------------------------------
    ysplit_chunks = None  # (cy, cx) when Z rows split Y across ranks
    if multiproc and out_path is not None and ny > 1:
        # A Z row whose Y shards live on several ranks means two ranks
        # write the SAME z planes. That is safe iff the store's Y chunk
        # grid is aligned to every Y shard boundary (trim + j*own), so
        # the ranks touch disjoint chunk keys; gcd(trim, own) divides all
        # of them (and the leading trim offset).
        ysplit_chunks = _ysplit_chunk_grid(trim, yp.own, dim)
    chunk_kw = {"chunks_yx": ysplit_chunks} if ysplit_chunks else {}
    writers = None
    out = None
    asm_channels = 4 if predigest else out_channels
    asm_dtype = np.uint8 if predigest else np.float32
    out_shape = (out_channels,) + dim if affinity_mode else dim
    if out_path is not None:
        # plane writers take any rank's rows; append writers need one
        # writer that sees every row in order (a mesh of one rank)
        cls = ZarrPlaneWriter if multiproc else ZarrAppendWriter
        kw = chunk_kw if multiproc else {}
        if predigest:
            writers = (cls(out_path[0], dim, np.uint8, **kw),
                       cls(out_path[1], (3,) + dim, np.uint8, **kw))
        else:
            writers = (cls(out_path, out_shape, np.float32, **kw),)

        def emit(z_lo, block, y_ranges=None):
            parts = ((block[0], block[1:]) if predigest else
                     (block if affinity_mode else block[0],))
            for writer, part in zip(writers, parts):
                if not multiproc:
                    writer.append(part)
                    continue
                for ya, yb in y_ranges or [(0, dim[1])]:
                    writer.write_planes(z_lo, part[..., ya:yb, :], y0=ya)
    else:
        # Dense assembly. On a multi-rank mesh each rank fills only its
        # own rows; everything else stays zero. With predigest the 4 u8
        # channels are [plan, qaff_z, qaff_y, qaff_x]; zero margins ARE
        # the correct digest of the zero trim planes.
        out = np.zeros((asm_channels,) + dim, asm_dtype)

        def emit(z_lo, block, y_ranges=None):
            out[:, z_lo: z_lo + block.shape[1]] = block

    # the last slot of an axis also keeps its unsent spill, and with
    # predigest the digested plane past it
    extra = 1 if predigest else 0

    def y_extent(j):
        """(y_base, y_hi, last_y) of Y shard ``j`` in the output."""
        y_base = j * yp.own + trim
        last_y = j == ny - 1 or (j + 1) * yp.own + trim >= dim[1]
        y_hi = min(y_base + yp.own + (yp.spill + extra if last_y else 0),
                   dim[1])
        return y_base, y_hi, last_y

    # --- Band loop ------------------------------------------------------
    next_z = 0
    for plan in band_plans:
        in_lo = plan["in_range"][0]
        own_hi = plan["own"][1]
        with _st("load_slabs"):
            slab = first_slab if first_slab is not None else load_slab(in_lo)
        first_slab = None  # free after use
        with _st("forward"):
            data = forward_band(slab, in_lo, len(plan["rows"]))
        del slab

        # Assembly: each slot owns [z_base, z_base + own) clipped to the
        # band's owned range; the band's last real slot also keeps its
        # unsent spill. This rank materializes only its own slot's rows.
        with _st("fetch_assemble"):
            host = None
            hard_hi = min(own_hi, dim[0])
            for i in range(nz):
                z_base = in_lo + i * zp.own + trim
                if z_base >= hard_hi:
                    break
                last_b = (
                    i == nz - 1
                    or in_lo + (i + 1) * zp.own + trim >= hard_hi
                )
                z_hi_dev = min(
                    z_base + zp.own + (zp.spill + extra if last_b else 0),
                    hard_hi,
                )
                if z_hi_dev <= next_z:
                    if last_b:
                        break
                    continue
                if i != ci:
                    next_z = z_hi_dev
                    if last_b:
                        break
                    continue
                if host is None:
                    host = data.cpu().numpy()
                row = np.zeros(
                    (asm_channels, z_hi_dev - next_z, dim[1], dim[2]),
                    asm_dtype,
                )
                row_off = max(z_base - next_z, 0)  # leading trim gap
                src_z0 = max(next_z - z_base, 0)   # skip recomputed planes
                y_base, y_hi, last_y = y_extent(cj)
                if y_base < dim[1]:
                    n_planes = z_hi_dev - max(z_base, next_z)
                    row[:, row_off:, y_base:y_hi] = host[
                        :, src_z0: src_z0 + n_planes, : y_hi - y_base,
                        : dim[2]
                    ]
                if multiproc and writers is not None:
                    y_ranges = None
                    if ysplit_chunks is not None:
                        # write ONLY this rank's Y extent (chunk-aligned
                        # by construction); above the last shard the
                        # region is globally unowned (reads as fill=0):
                        # round up to the chunk grid, the row is zero
                        y_ranges = []
                        if y_base < dim[1]:
                            if last_y:
                                cy_out = ysplit_chunks[0]
                                y_hi = min(-(-y_hi // cy_out) * cy_out,
                                           dim[1])
                            y_ranges = [(y_base, y_hi)]
                    if y_ranges != []:
                        # skip leading gaps: those planes belong to the
                        # zarr fill value or to another rank's rows
                        emit(next_z + row_off, row[:, row_off:],
                             y_ranges=y_ranges)
                else:
                    emit(next_z, row)
                next_z = z_hi_dev
                if last_b:
                    break
            del data, host

    if not multiproc and writers is not None and next_z < dim[0]:
        # trailing never-covered trim planes (the append writers must
        # cover the full declared extent; the plane writers read them as
        # fill; dense output is already zero there)
        emit(next_z, np.zeros(
            (asm_channels, dim[0] - next_z, dim[1], dim[2]), asm_dtype))

    if writers is not None:
        if not multiproc:  # append writers verify + flush
            for writer in writers:
                writer.close()
        # Host-side writes are not ordered by the collectives above: a
        # rank returning its lazy handle early could read rows a peer
        # has not written yet. Barrier before anyone reads.
        barrier(mesh)
        if predigest:
            return read(out_path[0]), read(out_path[1])
        return read(out_path)
    if predigest:
        return out[0], np.ascontiguousarray(out[1:])
    return out if affinity_mode else out[0]
