"""Beyond-RAM affinity -> segmentation driver over the streaming engine.

Streams a lazy chunked affinity handle (zarr/N5, shape (3, D, H, W))
through three Z-slab passes (native ``streamseg.cpp`` via
:class:`..native.StreamSegmenter`):

1. device pre-digest (:func:`..ops.predigest.predigest_slab`, on the
   card unless ``device="cpu"``) + slab watershed; provisional fragment
   labels and u8 affinities spool to sequential temp files (7
   bytes/voxel of DISK, not RAM);
2. streamed RAG build + the shared merge loop + threshold/min-size
   lut composition;
3. relabel slabs through the lut into a dense array or a Zarr store.

Peak host RAM is O(RAG + slab): none of the float volume, the digests,
the fragment volume, or a voxel-granular union-find is ever dense in
memory -- the dense engine's ~16 bytes/voxel of transient state becomes
~7 bytes/voxel of sequentially-accessed temp disk. Output is
bit-identical to the dense path (reference inference.py:196-237 +
utils/img_util.py:536-559 semantics) and to the JAX package's
``segment_streaming`` (tests/test_torch_streaming.py).
"""

import os
import shutil
import sys
import tempfile
import time

import numpy as np

from aind_exaspim_neuron_segmentation_tpu_torch import native
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import (
    ZarrAppendWriter,
    open_zarr,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops.predigest import (
    default_slab_planes,
    predigest_slabs,
)


class _SlabFile:
    """Sequential slab spool: plain buffered file I/O, not mmap.

    The temp volumes are written once and re-read sequentially, so a
    memory MAPPING buys nothing and costs twice: per-page minor faults
    on every touch, and -- decisive for the beyond-RAM contract --
    dirty mmap pages count toward the process RSS until writeback, so
    a streaming pass LOOKS like it held the whole volume in RAM
    (peak-RSS timelines confirmed growth to ~the kernel dirty-threshold
    ceiling). write()/read() move the data through the kernel page
    cache instead, which is reclaimable and never attributed to this
    process.
    """

    def __init__(self, path):
        self._f = open(path, "wb+", buffering=0)
        self._offsets = []  # byte offset of each slab, append order

    def write_slab(self, arr):
        """Append one contiguous slab (any shape/dtype, recorded)."""
        self._offsets.append(self._f.tell())
        self._f.write(memoryview(np.ascontiguousarray(arr)))

    def read_slab(self, i, shape, dtype):
        """Read back slab ``i`` as ``shape``/``dtype`` (writable copy)."""
        self._f.seek(self._offsets[i])
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        buf = bytearray(self._f.read(n))
        return np.frombuffer(buf, dtype).reshape(shape)

    def close(self):
        """Close the spool file handle."""
        self._f.close()


def segment_streaming(
    affinities,
    agglomeration_thresholds=(0.6, 0.8, 0.9),
    min_segment_size=100,
    aff_threshold_low=0.1,
    aff_threshold_high=0.9999,
    quantile_pct=85,
    out_path=None,
    tmp_dir=None,
    slab_planes=None,
    verbose=False,
    device=None,
):
    """Lazy (3, D, H, W) affinity handle -> final-threshold segmentation.

    ``quantile_pct``: the merge score's affinity quantile (score = 1 -
    quantile of the edge's affinities), 85 as in the reference.

    ``out_path``: when set, the labeling streams into a Zarr store there
    (uint32, Z-slab chunks) and the opened lazy handle is returned;
    otherwise a dense uint32 array is returned (RAM permitting --
    4 bytes/voxel for the result only).

    ``tmp_dir``: directory for the two temp spool files (~7 bytes/voxel,
    deleted on return). ``slab_planes``: Z planes per slab (default
    sizes the device digest slab to ~512 MB of f32). ``verbose``:
    stderr stamps at each phase boundary. ``device``: where float
    affinities are digested (default ``cuda``; raises without a card).

    ``affinities`` may also be a ``(plan, qaff)`` PAIR of lazy handles,
    e.g. from ``predict(..., predigest=True, out_path=(p1, p2))``: the
    card already digested the volume, so pass 1 replays pure integer
    work straight from the plan store (no device involvement, no qaff
    spool -- the qaff store is re-read in pass 2) and the low/high
    thresholds must be the defaults baked in at digest time.

    Requires ``aff_threshold_low <= aff_threshold_high`` (the pipeline
    default): the slab watershed's cross-boundary stitching relies on
    background voxels never joining fragments, which only >= low
    unions guarantee (streamseg.cpp header note).
    """
    digest_pair = isinstance(affinities, (tuple, list))
    if digest_pair:
        plan_h, qaff_h = affinities
        if (aff_threshold_low, aff_threshold_high) != (0.1, 0.9999):
            raise ValueError(
                "aff thresholds are baked into the plan bytes at digest "
                "time; re-digest for non-defaults"
            )
        if plan_h.ndim != 3 or qaff_h.shape != (3,) + tuple(plan_h.shape):
            raise ValueError(
                f"digest pair shapes {plan_h.shape} / {qaff_h.shape} "
                "do not match"
            )
        d, h, w = plan_h.shape
    else:
        if affinities.ndim != 4 or affinities.shape[0] != 3:
            raise ValueError(
                f"expected (3, D, H, W) handle, got {affinities.shape}"
            )
        _, d, h, w = affinities.shape
    if aff_threshold_low > aff_threshold_high:
        raise ValueError(
            "streaming segmentation requires aff_threshold_low <= "
            "aff_threshold_high"
        )
    th = list(agglomeration_thresholds)
    if not th or any(b < a for a, b in zip(th, th[1:])):
        raise ValueError("thresholds must be non-empty and ascending")

    if slab_planes is None:
        slab_planes = default_slab_planes(h, w)
    bounds = [
        (lo, min(lo + slab_planes, d)) for lo in range(0, d, slab_planes)
    ]
    if not digest_pair:
        slabs = predigest_slabs(affinities, aff_threshold_low,
                                aff_threshold_high, slab_planes, device)

    t0 = time.time()

    def stamp(msg):
        if verbose:
            print(f"[segment_streaming {time.time() - t0:7.0f}s] {msg}",
                  file=sys.stderr, flush=True)

    work = tempfile.mkdtemp(prefix="exa_streamseg_", dir=tmp_dir)
    try:
        frag_sp = _SlabFile(os.path.join(work, "frag.u32"))
        qaff_sp = None
        seg = native.StreamSegmenter((d, h, w))

        if digest_pair:
            # Pass 1: pure integer replay from the plan store.
            for lo, hi in bounds:
                frag_sp.write_slab(
                    seg.feed(np.asarray(plan_h[lo:hi], dtype=np.uint8))
                )
        else:
            # Plane-major qaff spool so pass-2 slabs come back in
            # rag_feed's (nz, 3, H, W) layout.
            qaff_sp = _SlabFile(os.path.join(work, "qaff.u8"))
            # Pass 1: digest on device, watershed + stitch on host.
            for _, _, plan, qaff in slabs:
                frag_sp.write_slab(seg.feed(plan.cpu().numpy()))
                qaff_sp.write_slab(qaff.movedim(0, 1).cpu().numpy())
            del plan, qaff
        stamp("pass 1 (digest + watershed + stitch) done")
        seg.fragments_done()
        stamp(f"fragments stitched: K={seg.n_fragments}")

        # Pass 2: streamed RAG build, then merge + lut composition.
        for i, (lo, hi) in enumerate(bounds):
            nz = hi - lo
            if qaff_sp is not None:
                q_slab = qaff_sp.read_slab(i, (nz, 3, h, w), np.uint8)
            else:
                q_slab = np.moveaxis(
                    np.asarray(qaff_h[:, lo:hi], dtype=np.uint8), 0, 1
                )
            seg.rag_feed(
                frag_sp.read_slab(i, (nz, h, w), np.uint32), q_slab
            )
        stamp("pass 2 (RAG build) done")
        seg.merge(th, quantile_pct=quantile_pct,
                  min_segment_size=min_segment_size)
        stamp(f"merge done: n_segments={seg.n_segments}")
        if qaff_sp is not None:
            qaff_sp.close()

        # Pass 3: relabel.
        if out_path is not None:
            writer = ZarrAppendWriter(out_path, (d, h, w), np.uint32)
            for i, (lo, hi) in enumerate(bounds):
                writer.append(
                    seg.map(frag_sp.read_slab(i, (hi - lo, h, w),
                                              np.uint32))
                )
            writer.close()
            seg.close()
            frag_sp.close()
            return open_zarr(out_path)
        out = np.empty((d, h, w), np.uint32)
        for i, (lo, hi) in enumerate(bounds):
            out[lo:hi] = seg.map(
                frag_sp.read_slab(i, (hi - lo, h, w), np.uint32)
            )
        seg.close()
        frag_sp.close()
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)
