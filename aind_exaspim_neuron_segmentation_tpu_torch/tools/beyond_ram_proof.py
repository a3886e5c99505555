"""Beyond-RAM proof: N^3 zarr affinities -> zarr labels -> SWC zip.

Synthesizes a (3, N, N, N) float32 affinity store slab by slab (never
dense; spheres of high affinity on a below-threshold background), then
runs the fully streaming chain -- ``segment_streaming(lazy,
out_path=...)``, which digests each float slab on the device and runs the
slab-streaming engine on the host, and ``segmentation_to_zipped_swcs``
(per-label bounding-box-crop TEASAR) -- while a sampler thread records
the host RSS so peaks attribute to phases.

``--ranks K`` runs the SAME store through the multi-process engines
instead: K local ``torch.distributed`` processes (gloo; on one card they
share it) driving ``segment_streaming_sharded`` + ``skeletonize_sharded``.
It records each rank's walls, hub payload bytes and peak RSS and, when
the single-process zip exists from an earlier run in the same work
directory, asserts that the distributed SWC zip is entry-identical to it.

Usage::

    python -m aind_exaspim_neuron_segmentation_tpu_torch.tools.beyond_ram_proof \
        [N] [work_dir] [--ranks K] [--device cpu]

Defaults: N=1024, work_dir the system's temporary directory, one
process, device ``cuda``. Writes ``<work>/proof_aff.zarr`` (kept for
re-runs), ``<work>/proof_seg.zarr`` and ``<work>/proof_swcs.zip``
(``proof_seg_dist.zarr`` / ``proof_swcs_dist.zip`` with --ranks), and
``<work>/proof_rss.npy`` (the (t, GB) timeline; ``proof_rank{r}_rss.npy``
with --ranks). The last line of the output is one JSON object: N, the
walls per stage, the peak RSS and the skeleton count.
"""

import json
import os
import sys
import tempfile
import threading
import time
import zipfile

import numpy as np

from aind_exaspim_neuron_segmentation_tpu_torch.core.device import (
    resolve_device,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io import zarr_lite
from aind_exaspim_neuron_segmentation_tpu_torch.parallel import launch

MODULE = "aind_exaspim_neuron_segmentation_tpu_torch.tools.beyond_ram_proof"


def _status_gb(key):
    """A ``/proc/self/status`` size in GB; 0 where the kernel lacks it."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 1e6
    return 0.0


def cur_rss():
    """This process's resident set, GB."""
    return _status_gb("VmRSS")


class RssSampler:
    """0.5 s RSS timeline and the peak, shared by all proof modes.

    The peak is ``VmHWM`` where the kernel reports it, else the timeline's
    maximum: some kernels (gVisor's) report no ``VmHWM``, and ``ru_maxrss``
    keeps the high-water mark of the process that forked this one.
    """

    def __init__(self):
        self.t0 = time.time()
        self.samples = []
        self._stop = threading.Event()
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while not self._stop.is_set():
            self.samples.append((time.time() - self.t0, cur_rss()))
            self._stop.wait(0.5)

    def peak(self):
        """Peak resident set so far, GB."""
        sampled = max((gb for _, gb in self.samples), default=0.0)
        return max(_status_gb("VmHWM"), sampled, cur_rss())

    def stamp(self, msg):
        print(f"[{time.time() - self.t0:7.0f}s cur={cur_rss():5.2f} "
              f"peak={self.peak():5.2f}GB] {msg}", flush=True)

    def finish(self, npy_path):
        self._stop.set()
        arr = np.asarray(self.samples)
        if len(arr):
            np.save(npy_path, arr)
        return self.peak()


def synth_store(n, work, sampler=None):
    """Write the (3, n, n, n) sphere affinity store if absent; return
    its path. A seeded rng stream: the same n gives the same bytes."""
    r, slab = 15, 32
    aff_path = os.path.join(work, "proof_aff.zarr")
    if os.path.exists(os.path.join(aff_path, ".zarray")):
        return aff_path
    rng = np.random.default_rng(0)
    # 2560 spheres in 1024^3, the density scaled with the volume
    n_spheres = max(int(2560 * (n / 1024) ** 3), 8)
    centers = rng.integers(r + 2, n - r - 2, (n_spheres, 3))
    w = zarr_lite.ZarrAppendWriter(
        aff_path, (3, n, n, n), np.float32, chunks=(slab, 256, 256),
    )
    by_slab = {}
    for (cz, cy, cx) in centers:
        for s in range(max(0, (cz - r) // slab),
                       min((n - 1) // slab, (cz + r) // slab) + 1):
            by_slab.setdefault(s, []).append((cz, cy, cx))
    # ceil-div so a trailing partial slab still writes (the append
    # writer's close() verifies full Z coverage)
    for s in range(-(-n // slab)):
        z0 = s * slab
        nz = min(slab, n - z0)
        lbl = np.zeros((nz, n, n), bool)
        for (cz, cy, cx) in by_slab.get(s, []):
            zl, zh = max(z0, cz - r), min(z0 + nz, cz + r + 1)
            zz = np.arange(zl, zh)[:, None, None] - cz
            yy = np.arange(cy - r, cy + r + 1)[None, :, None] - cy
            xx = np.arange(cx - r, cx + r + 1)[None, None, :] - cx
            lbl[zl - z0: zh - z0, cy - r: cy + r + 1,
                cx - r: cx + r + 1] |= zz**2 + yy**2 + xx**2 < r**2
        base = np.where(lbl, np.float32(0.9), np.float32(0.02))
        aff = np.empty((3, nz, n, n), np.float32)
        for c in range(3):
            aff[c] = base + rng.uniform(
                -0.05, 0.05, (nz, n, n)).astype(np.float32)
        np.clip(aff, 0.0, 1.0, out=aff)
        w.append(aff)
    w.close()
    if sampler:
        sampler.stamp("affinity zarr written")
    return aff_path


def main_single(n, work, device):
    """The one-process proof; returns the result line's fields."""
    from aind_exaspim_neuron_segmentation_tpu_torch import inference
    from aind_exaspim_neuron_segmentation_tpu_torch.postprocess.streaming import (  # noqa: E501
        segment_streaming,
    )

    sampler = RssSampler()
    walls = {}
    t0 = time.perf_counter()
    aff_path = synth_store(n, work, sampler)
    walls["synth_s"] = time.perf_counter() - t0
    lazy = zarr_lite.open_zarr(aff_path)
    sampler.stamp(f"opened lazy handle {lazy.shape}")
    t0 = time.perf_counter()
    seg_h = segment_streaming(
        lazy, out_path=os.path.join(work, "proof_seg.zarr"),
        tmp_dir=work, verbose=True, device=device,
    )
    walls["segment_s"] = time.perf_counter() - t0
    sampler.stamp("segmentation streamed to zarr")
    zp = os.path.join(work, "proof_swcs.zip")
    t0 = time.perf_counter()
    inference.segmentation_to_zipped_swcs(seg_h, zp)
    walls["skeletonize_s"] = time.perf_counter() - t0
    n_swc = len(zipfile.ZipFile(zp).namelist())
    sampler.stamp(f"SWC zip done: {n_swc} skeletons, "
                  f"{os.path.getsize(zp)} bytes")
    peak = sampler.finish(os.path.join(work, "proof_rss.npy"))
    arr = np.asarray(sampler.samples)
    print(f"PEAK RSS {peak:.2f} GB; timeline max {arr[:, 1].max():.2f} GB "
          f"at t={arr[arr[:, 1].argmax(), 0]:.0f}s")
    return dict(n=n, ranks=1, device=device.type, walls_s=walls,
                peak_rss_gb=peak, n_skeletons=n_swc)


def main_worker(work, device):
    """One rank of the --ranks proof: distributed segment + skeletons;
    its figures go to ``work/proof_rank<r>.json``."""
    import torch.distributed as dist

    from aind_exaspim_neuron_segmentation_tpu_torch import parallel, postprocess

    parallel.initialize_distributed(device=device)
    rank = dist.get_rank()
    sampler = RssSampler()
    lazy = zarr_lite.open_zarr(os.path.join(work, "proof_aff.zarr"))
    seg_p = os.path.join(work, "proof_seg_dist.zarr")
    zp = os.path.join(work, "proof_swcs_dist.zip")
    t0 = time.perf_counter()
    seg_stats = {}
    seg_h = postprocess.segment_streaming_sharded(
        lazy, out_path=seg_p, tmp_dir=work, verbose=(rank == 0),
        stats_out=seg_stats, device=device,
    )
    t1 = time.perf_counter()
    sampler.stamp(f"rank {rank}: distributed segmentation done")
    sk_stats = {}
    postprocess.skeletonize_sharded(seg_h, zip_path=zp, stats_out=sk_stats)
    t2 = time.perf_counter()
    sampler.stamp(f"rank {rank}: distributed skeletonization done")
    peak = sampler.finish(os.path.join(work, f"proof_rank{rank}_rss.npy"))
    with open(os.path.join(work, f"proof_rank{rank}.json"), "w") as f:
        json.dump({
            "rank": rank, "wall_segment_s": t1 - t0,
            "wall_skeletonize_s": t2 - t1, "peak_rss_gb": peak,
            "segment_stats": seg_stats.get("ranks", seg_stats),
            "skeletonize_stats": sk_stats.get("ranks", sk_stats),
        }, f, indent=1)
    dist.destroy_process_group()


def zips_identical(path_a, path_b):
    """Whether two zips hold the same entries with the same bytes."""
    za, zb = zipfile.ZipFile(path_a), zipfile.ZipFile(path_b)
    if sorted(za.namelist()) != sorted(zb.namelist()):
        return False
    return all(za.read(name) == zb.read(name) for name in za.namelist())


def main_distributed(n, work, ranks, device, timeout=3600):
    """The --ranks proof over ``ranks`` local processes; returns the
    result line's fields."""
    sampler = RssSampler()
    t0 = time.perf_counter()
    synth_store(n, work, sampler)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    launch.run(launch.module_argv(MODULE, "--worker", work, "--device",
                                  device.type),
               ranks, work, "proof", timeout)
    wall = time.perf_counter() - t0
    sampler.stamp(f"all {ranks} ranks done")
    rows = []
    for r in range(ranks):
        with open(os.path.join(work, f"proof_rank{r}.json")) as f:
            rows.append(json.load(f))
    print(f"{'rank':>4} {'segment_s':>10} {'skeleton_s':>11} "
          f"{'peak_rss_gb':>12}")
    for row in rows:
        print(f"{row['rank']:>4} {row['wall_segment_s']:>10.1f} "
              f"{row['wall_skeletonize_s']:>11.1f} "
              f"{row['peak_rss_gb']:>12.2f}")
    print("rank-0 protocol stats:",
          json.dumps(rows[0]["segment_stats"], indent=1))
    print("rank-0 skeleton stats:",
          json.dumps(rows[0]["skeletonize_stats"], indent=1))
    zp_single = os.path.join(work, "proof_swcs.zip")
    zp_dist = os.path.join(work, "proof_swcs_dist.zip")
    n_swc = len(zipfile.ZipFile(zp_dist).namelist())
    identical = None
    if os.path.exists(zp_single):
        identical = zips_identical(zp_single, zp_dist)
        if not identical:
            raise AssertionError(
                f"{zp_dist} differs from the single-process {zp_single}")
        print(f"SWC zips ENTRY-IDENTICAL: {n_swc} skeletons match the "
              "single-process proof byte for byte")
    else:
        print(f"(no {zp_single}; run the single-process proof first "
              "for the identity check)")
    peak = max([sampler.finish(os.path.join(work, "proof_rss.npy"))]
               + [row["peak_rss_gb"] for row in rows])
    walls = dict(synth_s=synth_s, ranks_s=wall,
                 segment_s=[row["wall_segment_s"] for row in rows],
                 skeletonize_s=[row["wall_skeletonize_s"] for row in rows])
    return dict(n=n, ranks=ranks, device=device.type, walls_s=walls,
                peak_rss_gb=peak, n_skeletons=n_swc,
                entry_identical=identical)


def main(argv):
    argv = list(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    device = resolve_device(device)
    if argv[:1] == ["--worker"]:
        main_worker(argv[1], device.type)
        return 0
    ranks = 1
    if "--ranks" in argv:
        i = argv.index("--ranks")
        ranks = int(argv[i + 1])
        del argv[i: i + 2]
    n = int(argv[0]) if len(argv) > 0 else 1024
    work = argv[1] if len(argv) > 1 else tempfile.gettempdir()
    os.makedirs(work, exist_ok=True)
    if ranks > 1:
        result = main_distributed(n, work, ranks, device)
    else:
        result = main_single(n, work, device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
