#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the repository root with one CUDA device::

    python3 chip_smoke.py            # build, check, drive, report
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns of
                                     # a predict and two train steps

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build kernel K1 (``csrc/scatter_blend.cu``, one ``nvcc``); hold it
   against its plain version with ``torch.equal`` on six cases, the
   main-path shape among them, each printed with the path it took
   (``vec 4`` or ``vec 1``, both required), and time it, the plain loop
   and the library call ``index_add_`` with CUDA events at two shapes:
   the main path's batch and a strip of 16 patches along x;
3. the float32 forward on the card against the port's CPU forward
   (width 0.25, 32^3, TF32 off, max-abs <= 1e-4), and a small float32
   ``predict`` on the card against the CPU (MAE <= 1e-5);
4. the main path at full width: ``load_model`` (bf16, folded BN) of a
   checkpoint with seeded random weights and BatchNorm statistics taken
   from real activations, ``predict`` and ``predict(predigest=True)`` of
   a seeded 256^3 uint16 volume (64 patches of 96^3, 4 batches of 16),
   with K1's launch count read around it; then the same checkpoint in
   float32 (TF32 off, BN unfolded) on the same volume, the bf16
   affinities held to MAE <= 5e-3 and max-abs <= 0.15 of it;
5. the host tail's build: ``g++ --version``, ``os.cpu_count()``, whether
   ``zlib.h`` and ``zstd.h`` compile (printed, never a failure), and the
   port's C++ engine built with ``g++`` and timed;
6. the tail's known answer at 256^3: 32 separated tubes, their exact
   affinities made (``core.affinities.affinity_channels``) and digested
   (``predigest_slab``) on the card; ``affinities_to_segmentation`` of
   the digest pair equals that of the float affinities bit for bit, and
   both equal the tubes renumbered; ``segmentation_to_zipped_swcs``
   writes ``1.swc`` .. ``32.swc``, and every vertex of
   ``voxelize_skeletons`` lies in its own segment;
7. the main path's tail: phase 4's digest pair segmented (the engine's
   stage times on stderr, ``EXA_DEBUG_TIMING``) into labels ``1..n``
   each over 100 voxels, skeletonized into a zip whose entries are
   exactly the ids, with the stage times; then a 128^3 crop of phase
   4's float affinities digested on the card, whose pair labels equal
   its float labels bit for bit;
8. the io build: whether the engine (now with the codecs and the
   streaming segmenter) got the system zstd (``exa_have_zstd``, a missing
   zstd is printed, never a failure), phase 5's build time, and a blosc
   round trip;
9. the lazy main path at full width: phase 4's volume written to a zarr
   v2 store with ``blosc`` (lz4, byte shuffle), opened with ``io.read``
   and run through ``predict(predigest=True, out_path=(plan, qaff))`` with
   K1's launches counted around it; ``streaming_percentile`` printed
   beside ``np.percentile`` (equal, or the phase fails); the stores equal
   phase 4's in-RAM digest pair; the streaming segmentation of the store
   pair (``out_path``, stage stamps on stderr) equals phase 7's labels;
10. the lazy float path: phase 7's 128^3 crop of float affinities as a
    zarr store, digested on the card inside ``segment_streaming``, equals
    the crop's dense labels;
11. lazy TEASAR: phase 6's 32-tube labels as a zarr store give the same 32
    zip entries, byte for byte, as phase 6's dense zip;
12. the CLI: ``python -m aind_exaspim_neuron_segmentation_tpu_torch run``
    in a subprocess (no ``--device``) on a 128^3 crop of the volume at
    full width with phase 4's checkpoint; its ``segmentation.zarr`` and
    zip entries equal the library path on the same lazy handle;
13. training, which reaches no hand kernel (K1's count is read around it,
    0): (a) one float32 train step (TF32 off) at width 0.25, 32^3, batch
    2 on the card against the CPU from the same seeded weights, the loss
    within 1e-5 relative, per tensor the gradients within 1e-3 of the
    tensor's max-abs gradient of each other and of a float64 forward and
    backward on the CPU, the worst four tensors printed (the conv biases
    that feed a BatchNorm, whose true gradient is 0, both <= 1e-6 of the
    largest); (b) the
    device augmentation at 16 x 96^3 given the same draws on the card and
    the CPU, flips, rotations and labels bit-equal, noise, smoothing and
    contrast within max-abs 1e-6, and its time on the card; (c)
    ``Trainer(batch_size=16, use_amp=True)`` at full width on 8 seeded
    uint16 160^3 volumes with tube labels, ``TrainDataset(
    return_label_patches=True)`` (augmentation on the card, raw u16 wire)
    and ``ValidateDataset(containment_buffer=0)``, ``run`` for 2 epochs of
    2 steps plus validation: every loss finite, the step times on the
    device (CUDA events, first and warm median), the host's enqueue time
    and input wait, patches/s, peak device memory; the best-F1 ``.pth``
    loads strictly into ``load_model`` (bf16, folded) and ``predict`` on a
    128^3 crop gives finite affinities; then ``python -m
    aind_exaspim_neuron_segmentation_tpu_torch train`` in a subprocess (no
    ``--device``) on the same volumes as blosc zarr stores, batch 16,
    96^3, 1 epoch: its JSON line names its run directory, whose best-F1
    ``.pth`` loads into ``load_model``;
14. the multi-rank path (``parallel``, ``postprocess.distributed``):
    (a) a process group of one rank over NCCL: the mesh-wide order
    statistics of phase 4's clipped volume equal ``np.percentile`` bit for
    bit, ``predict_sharded`` on its (1,) mesh equals phase 4's ``predict``
    within max-abs 1e-6 with K1's launches counted around it, and its
    ``predigest=True`` bytes equal the digest of its floats; (b) two gloo
    ranks on the one card (NCCL refuses two ranks on one device), this
    script run as ``--sharded-rank``: ``predict_sharded`` of phase 9's
    zarr store into a shared store, within 1e-6 of (a), each rank's K1
    launches counted and K1 held to its plain loop at the rank's slab
    shape; ``segment_streaming_sharded`` of phase 9's digest stores and
    ``skeletonize_sharded`` of phase 11's tube store give phase 9's labels
    and phase 11's zip entries; (c) at the same time, ``python -m
    aind_exaspim_neuron_segmentation_tpu_torch run --distributed`` in two
    processes on phase 12's crop: one JSON line, phase 12's labels and
    zip entries;
15. the valid-region decoder and data-parallel training: (a) 16 patches
    of 96^3 of phase 4's volume through ``forward_batch`` with
    ``valid_trim=8`` (up3's cascade, up4's unpadded convs) against the
    sliced full forward of the same module, float32 (TF32 off, MAE <=
    1e-5) and bf16 folded (printed), each path timed with CUDA events
    (median of 5); (b) ``Trainer(mesh=make_mesh())`` on a process group
    of one rank over NCCL, full width, batch 16, 96^3, bf16, augmentation
    on the card, phase 13's volumes, two steps: a mesh of one rank keeps
    the native BatchNorm and adds no collective (checked), so its step is
    the one without a mesh; then (c)'s references in one process: the
    first step (logits, loss, gradients) of the Trainer without a mesh
    whose BatchNorms are ``convert_sync_batchnorm(model, None)`` (the
    ranks' BatchNorm, over the whole batch), run twice, and with cuDNN's
    BatchNorm, same volumes, seed and size, and one float32 step (TF32
    off) without a mesh at phase 13 (a)'s size (width 0.25, a host batch
    of 4 x 32^3) with the float64 gradients of its weights on the CPU;
    (c) two gloo ranks on the one card, this script run as
    ``--dp-rank``: ``Trainer(mesh=make_mesh(2))`` takes the same float32
    step (2 patches a rank), its gradients within 1e-3 of each tensor's
    max of (b)'s, and from float64 within 1e-3 or twice (b)'s own
    distance; then ``run`` for 2 epochs of 2 steps at full width, global
    batch 16, bf16, augmentation on the card: its first step against the
    synchronized-BatchNorm process's, the logits' MAE, the loss, the
    gradients' relative L2 and its median over the tensors each within
    twice what swapping cuDNN's BatchNorm for the synchronized one moves
    them in one process (a bf16 forward that rounds differently moves
    the logits by bf16 ulps and the gradients by routing flips), each
    rank's step times, patches/s, input wait and peak memory printed;
    both ranks' parameters and BatchNorm buffers equal after it; (d)
    ``python -m aind_exaspim_neuron_segmentation_tpu_torch train
    --distributed`` in two processes on phase 13's stores, patch 96,
    batch 4, 1 epoch: one JSON line, rank 1's run under ``.rank1``;
16. the entry points, the examples and the tools, each through the
    entry point a user calls: (a) ``entry.entry()``, its bf16 output
    (1, 3, 96, 96, 96), finite, in [0, 1], held to the same seeded module
    in float32 (TF32 off, MAE <= 5e-3, max-abs <= 0.15) and timed warm
    with CUDA events; (e) ``tools.traffic_audit`` at batch 16 with trim 0
    and trim 8 in subprocesses, their per-op tables and measured/minimal
    ratios printed; (b) ``entry.dryrun_multichip(8)``: eight gloo ranks
    on the card, a 4 x 2 mesh, the digest's distributed segmentation and
    skeletonization bit-identical to one process, K1's launches counted
    on each rank; (c) the three examples as subprocesses (no
    ``--device``), together and while (b) runs: ``run_pipeline``'s zip
    holds exactly the ids of its segments, ``run_beyond_ram``'s label
    store equals the dense labels of its affinity store,
    ``run_multichip``'s 1-D result lies within 1e-6 of ``predict``, each
    one's K1 launches counted; (d) ``tools.beyond_ram_proof`` at N = 512
    (the tool's 1024 cut to the time limit) in one process and then with
    ``--ranks 2`` on the same store, the two zips entry-identical, the
    walls, the RSS stamps and the peak RSS printed (the order of the run:
    a, e, b with c, d);
17. one ``{"kernels": [...]}`` line, the card line, and as the last line
    ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import zipfile

import numpy as np
import torch

# H100 SXM data-sheet peaks: HBM bytes/s and float32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# ~50 ms of device clock cycles, longer than the host takes to queue a
# timed run of K1, its plain loop or index_add_
SPIN_CYCLES = 100_000_000
PORT = "aind_exaspim_neuron_segmentation_tpu_torch"
K1_SOURCE = f"{PORT}/csrc/scatter_blend.cu"
# the beyond-RAM proof's edge in phase 16 (d): the tool's default 1024
# cut to fit the script's time limit
PROOF_N = 512
K1_REPLACES = (
    "aind_exaspim_neuron_segmentation_tpu/ops/experimental/"
    "pallas_stitch.py:95"
)


def check(cond, msg):
    """Raise unless ``cond`` holds."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


@contextlib.contextmanager
def tf32_off():
    """TF32 off in cuDNN and cuBLAS inside the block (or the decorated
    phase), so float32 on the card rounds as float32; the flags are
    restored after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device and host time of one call of ``fn`` in ms, after
    warm-up. The device time comes from CUDA events; the stream first
    spins for ~50 ms (``torch.cuda._sleep``), so the host has queued every
    call before the device reaches them and the host's own time per call
    (the second number) does not enter the first."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def k1_cases(rng):
    """(name, (acc, probs, starts, trim)) cases for K1, on the host."""
    from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
        patch_starts_array,
    )

    cases = []
    # the two cases of tests/test_pallas.py
    r0 = np.random.default_rng(0)
    cases.append(("pallas_overlaps", (
        r0.standard_normal((3, 32, 32, 32)).astype(np.float32),
        r0.standard_normal((4, 3, 8, 8, 8)).astype(np.float32),
        np.array([[0, 0, 0], [4, 4, 4], [4, 4, 4], [20, 16, 12]], np.int32),
        2,
    )))
    cases.append(("pallas_untouched", (
        np.random.default_rng(1).standard_normal(
            (1, 16, 16, 16)).astype(np.float32),
        np.ones((1, 1, 4, 4, 4), np.float32),
        np.array([[2, 2, 2]], np.int32),
        0,
    )))
    # seeded overlapping + duplicated starts, non-cubic core, trim 3
    core, trim, dims = (10, 12, 14), 3, (40, 44, 48)
    starts = np.stack([
        rng.integers(-trim, d - c - trim + 1, 24)
        for c, d in zip(core, dims)
    ], axis=1).astype(np.int32)
    starts[5] = starts[2]
    starts[17] = starts[2]
    cases.append(("random_overlapping", (
        rng.standard_normal((3,) + dims).astype(np.float32),
        rng.standard_normal((24, 3) + core).astype(np.float32),
        starts, trim,
    )))
    # the first 16 starts of a 36^3 grid (patch 20, overlap 12, trim 4):
    # two Z rows, voxels under up to 8 patches, aligned for float4
    r3 = np.random.default_rng(3)
    cases.append(("grid_rows_aligned", (
        r3.standard_normal((3, 36, 36, 36)).astype(np.float32),
        r3.standard_normal((16, 3, 12, 12, 12)).astype(np.float32),
        patch_starts_array((36,) * 3, (20,) * 3, (12,) * 3)[:16], 4,
    )))
    cases.append(("main_path", main_path_k1_case(rng)))
    return cases


def main_path_k1_case(rng):
    """One predict batch of the 256^3 main path: a Z row of 4x4 patches
    of 96^3 (trim 8 -> 80^3 cores) into the 288^3 padded slab."""
    grid = range(0, 256 - 96 + 64, 64)
    starts = np.array(
        [(64, y, x) for y in grid for x in grid], np.int32
    )
    return (
        rng.standard_normal((3, 288, 288, 288)).astype(np.float32),
        rng.random((16, 3, 80, 80, 80), dtype=np.float32),
        starts, 8,
    )


def strip_k1_case(rng):
    """The batch of a volume ~1024 voxels wide: 16 patches of 96^3 in one
    (z, y) row along x, starts (0, 0, 64k), trim 8, into 3 x 96^2 x 1056."""
    starts = np.array([(0, 0, 64 * k) for k in range(16)], np.int32)
    return (
        rng.standard_normal((3, 96, 96, 1056)).astype(np.float32),
        rng.random((16, 3, 80, 80, 80), dtype=np.float32),
        starts, 8,
    )


def k1_bound_ms(acc_shape, probs_shape, starts, trim):
    """Least time for one K1 call on these inputs: probs read once, the
    union of the patch cores in acc read once and written once."""
    covered = np.zeros(acc_shape[1:], bool)
    core = probs_shape[2:]
    for s in starts:
        lo = s + trim
        covered[tuple(slice(a, a + c) for a, c in zip(lo, core))] = True
    union = int(covered.sum())
    probs_bytes = int(np.prod(probs_shape)) * 4
    moved = probs_bytes + 2 * union * acc_shape[0] * 4
    adds = int(np.prod(probs_shape))
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), moved


def k1_flat_index(acc, probs, starts, trim):
    """Flat index into ``acc`` of every element of ``probs`` (int64, on
    ``acc``'s device): ``acc.view(-1).index_add_(0, idx, probs.view(-1))``
    is then K1's function in one library call."""
    c_, d, h, w = acc.shape
    dev = acc.device
    s = torch.from_numpy(starts.astype(np.int64) + trim).to(dev)
    z, y, x = (s[:, k, None, None, None, None]
               + torch.arange(n, device=dev).view(
                   [1, 1] + [n if j == k else 1 for j in range(3)])
               for k, n in enumerate(probs.shape[2:]))
    ch = torch.arange(c_, device=dev).view(1, c_, 1, 1, 1)
    return (((ch * d + z) * h + y) * w + x).reshape(-1)


def k1_check(scatter, dev, name, case):
    """Hold K1 against its plain loop on ``case``; returns the max abs
    error, the kernel's x width per thread and the plain result."""
    acc, probs, starts, trim = case
    acc_d = torch.from_numpy(acc).to(dev)
    probs_d = torch.from_numpy(probs).to(dev)
    want = scatter.scatter_batch_reference(acc_d.clone(), probs_d, starts,
                                           trim)
    got = scatter.scatter_batch(acc_d.clone(), probs_d,
                                torch.from_numpy(starts).to(dev), trim=trim,
                                host_starts=starts)
    torch.cuda.synchronize()
    vec = scatter.scatter_batch.last_vec
    err = (got - want).abs().max().item()
    check(torch.equal(got, want),
          f"K1 case {name} differs from the plain loop (max abs {err})")
    print(f"K1 case {name}: acc {acc.shape} probs {probs.shape} vec {vec}, "
          f"equal to the plain loop")
    return err, vec, want


def k1_time(scatter, dev, what, case, want, card):
    """Time K1, its plain loop, ``index_add_`` and a device copy of the
    same bytes on ``case`` (:func:`cuda_ms`); ``want`` is the plain loop's
    result, for index_add_'s error."""
    acc, probs, starts, trim = case
    acc_d = torch.from_numpy(acc).to(dev)
    probs_d = torch.from_numpy(probs).to(dev)
    starts_d = torch.from_numpy(starts).to(dev)
    kernel_ms, host_ms = cuda_ms(lambda: scatter.scatter_batch(
        acc_d, probs_d, starts_d, trim=trim, host_starts=starts))
    plain_ms, _ = cuda_ms(lambda: scatter.scatter_batch_reference(
        acc_d, probs_d, starts, trim))
    # index_add_ sums duplicates with atomics, in no fixed order: close to
    # the loop, not bit-identical; its index is built outside the clock
    idx = k1_flat_index(acc_d, probs_d, starts, trim)
    flat = probs_d.view(-1)
    lib = torch.from_numpy(acc).to(dev)
    lib.view(-1).index_add_(0, idx, flat)
    lib_err = (lib - want).abs().max().item()
    check(lib_err <= 1e-5, f"index_add_ differs from the loop by {lib_err}")
    library_ms, _ = cuda_ms(lambda: acc_d.view(-1).index_add_(0, idx, flat))
    bound_ms, bound_by, moved = k1_bound_ms(acc.shape, probs.shape,
                                            starts, trim)
    # what this card reaches on the same bytes: half read, half written
    src = torch.empty(moved // 8, device=dev)
    dst = torch.empty_like(src)
    copy_ms, _ = cuda_ms(lambda: dst.copy_(src))
    print(f"K1 {what} shape: kernel {kernel_ms:.4f} ms ({host_ms:.4f} ms "
          f"of host time per call), plain {plain_ms:.4f} ms, index_add_ "
          f"{library_ms:.4f} ms (max abs {lib_err:.3e} from the loop), "
          f"bound {bound_ms:.4f} ms ({bound_by}, {moved / 1e6:.2f} MB), "
          f"device copy of the same bytes {copy_ms:.4f} ms; kernel at "
          f"{moved / kernel_ms / 1e9:.3f} TB/s [{card}]")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_k1(scatter, dev, card):
    """Bit-equality of K1 against its plain loop on every case, and both
    of its paths taken; timing of K1, the loop and the library call
    ``index_add_`` at the main-path and the strip shapes."""
    rng = np.random.default_rng(7)
    max_err, vecs = 0.0, {}
    for name, case in k1_cases(rng):
        err, vecs[name], want = k1_check(scatter, dev, name, case)
        max_err = max(max_err, err)
    check(vecs["main_path"] == 4 and vecs["grid_rows_aligned"] == 4,
          f"aligned cases did not take vec 4: {vecs}")
    check(vecs["random_overlapping"] == 1,
          f"random_overlapping did not take vec 1: {vecs}")
    # the last case is the main-path shape
    timed = k1_time(scatter, dev, "main-path", case, want, card)
    strip = strip_k1_case(rng)
    err, vec, want = k1_check(scatter, dev, "strip", strip)
    check(vec == 4, f"strip took vec {vec}")
    k1_time(scatter, dev, "strip", strip, want, card)
    return dict(max_abs_err=max(max_err, err), **timed)


@tf32_off()
def phase_parity(inference, dev):
    """f32 forward and small predict on the card vs the port's CPU path."""
    kw = dict(width_multiplier=0.25, dtype=torch.float32)
    cpu = inference.load_model(device="cpu", **kw)
    gpu = inference.load_model(device=dev, **kw)
    x = np.random.default_rng(1).standard_normal(
        (2, 1, 32, 32, 32)).astype(np.float32)
    err = (gpu(x).cpu() - cpu(x)).abs().max().item()
    print(f"f32 forward, card vs CPU: max abs logits {err:.3e}")
    check(err <= 1e-4, f"f32 forward max abs {err} > 1e-4")

    vol = np.random.default_rng(0).uniform(0, 2000, (72, 56, 40))
    pkw = dict(patch_shape=(32,) * 3, overlap=(8,) * 3, trim=4,
               batch_size=4, verbose=False)
    want = inference.predict(vol.astype(np.float32), cpu, **pkw)
    got = inference.predict(vol.astype(np.float32), gpu, **pkw)
    mae = float(np.abs(got - want).mean())
    print(f"small f32 predict, card vs CPU: MAE {mae:.3e}, max abs "
          f"{np.abs(got - want).max():.3e}")
    check(mae <= 1e-5, f"small predict MAE {mae} > 1e-5")
    check(np.array_equal(got == 0, want == 0), "zero patterns differ")


def calibrated_checkpoint(inference, vol, dev, path):
    """Save seeded random full-width weights with real BatchNorm statistics.

    ``load_model``'s random init leaves BatchNorm at mean 0, variance 1 and
    weight 1, so folding it would change almost nothing and activations
    would fade layer by layer. One train-mode forward (``momentum=None``:
    the running statistics become the batch's) over two normalized 96^3
    patches of ``vol`` gives the statistics a trained checkpoint carries;
    the BatchNorm affine terms are drawn from a seeded generator.
    """
    from aind_exaspim_neuron_segmentation_tpu_torch.core import normalize

    net = inference.load_model(affinity_mode=True, device=dev,
                               dtype=torch.float32).module
    img = normalize(np.minimum(vol, 1000)).astype(np.float32)
    x = torch.from_numpy(np.stack([img[:96, :96, :96],
                                   img[-96:, -96:, -96:]])[:, None]).to(dev)
    gen = torch.Generator().manual_seed(1)
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm3d)]
    for m in bns:
        m.momentum = None
        m.reset_running_stats()
        m.weight.data.copy_(0.8 + 0.4 * torch.rand(m.weight.shape,
                                                   generator=gen))
        m.bias.data.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    with torch.no_grad():
        net.train()(x)
    net.eval()
    for m in bns:
        m.momentum = 0.1
    torch.save({k: v.cpu() for k, v in net.state_dict().items()}, path)


@tf32_off()
def phase_main(inference, predigest_slab, scatter, card, dev, tmp):
    """The main path at full width, then its float32 reference; returns
    the runner, the volume, the K1 launch count of the main path, its
    affinities and digest pair and the digest predict's wall seconds."""
    vol = np.random.default_rng(3).integers(
        0, 1500, (256, 256, 256), dtype=np.uint16)
    nvox = vol.size
    ckpt = f"{tmp}/unet3d_seeded.pth"
    calibrated_checkpoint(inference, vol, dev, ckpt)
    runner = inference.load_model(ckpt, affinity_mode=True, device=dev)
    check(runner.module.outc.conv.weight.dtype == torch.bfloat16
          and runner.module.fused_bn,
          "default CUDA model is not bfloat16 with folded BatchNorm")

    scatter.scatter_batch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aff = inference.predict(vol, runner, verbose=False)
    torch.cuda.synchronize()
    t_aff = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan, qaff = inference.predict(vol, runner, verbose=False,
                                   predigest=True)
    torch.cuda.synchronize()
    t_dig = time.perf_counter() - t0
    launches = scatter.scatter_batch.launches

    check(aff.shape == (3, 256, 256, 256) and aff.dtype == np.float32,
          f"affinities {aff.shape} {aff.dtype}")
    check(bool(np.isfinite(aff).all()), "non-finite affinities")
    check(aff.min() >= 0.0 and aff.max() <= 1.0, "affinities leave [0, 1]")
    check(not aff[:, :8].any() and not aff[:, :, :8].any()
          and not aff[:, :, :, :8].any(), "leading trim border not zero")
    check(aff[:, 8:, 8:, 8:].min() > 0.0, "covered voxel is zero")
    check(launches > 0, "predict did not launch K1")
    check(scatter.scatter_batch.last_vec == 4,
          f"predict took K1's vec {scatter.scatter_batch.last_vec} path")
    want_plan, want_q = predigest_slab(torch.from_numpy(aff))
    check(plan.shape == (256,) * 3 and qaff.shape == (3,) + (256,) * 3
          and plan.dtype == np.uint8 and qaff.dtype == np.uint8,
          "digest shapes")
    check(np.array_equal(plan, want_plan.numpy())
          and np.array_equal(qaff, want_q.numpy()),
          "on-card digest differs from the CPU digest of the floats")
    print(f"main path: predict {t_aff:.3f} s ({nvox / t_aff / 1e6:.2f} "
          f"Mvox/s), predict(predigest) {t_dig:.3f} s "
          f"({nvox / t_dig / 1e6:.2f} Mvox/s), first calls, K1 launches "
          f"{launches} [{card}]")

    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference.predict(vol, runner, verbose=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"main path warm: predict {med:.3f} s median of 3 "
          f"({nvox / med / 1e6:.2f} Mvox/s; runs {times}), peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card}]")

    ref = inference.load_model(ckpt, affinity_mode=True, device=dev,
                               dtype=torch.float32)
    check(not ref.module.fused_bn, "float32 reference folded BatchNorm")
    t0 = time.perf_counter()
    aff32 = inference.predict(vol, ref, verbose=False)
    t_ref = time.perf_counter() - t0
    diff = np.abs(aff - aff32)
    mae, max_abs = float(diff.mean()), float(diff.max())
    core = aff32[:, 8:, 8:, 8:]
    print(f"bf16 folded vs float32 unfolded (TF32 off), 256^3 affinities: "
          f"MAE {mae:.3e}, max abs {max_abs:.3e}; float32 affinities mean "
          f"{core.mean():.4f}, std {core.std():.4f}; float32 predict "
          f"{t_ref:.3f} s [{card}]")
    # bf16 rounds to 2^-9 relative at every layer; a wrong cast or fold
    # moves the MAE to the order of the affinities' spread (std ~0.09)
    check(mae <= 5e-3 and max_abs <= 0.15,
          f"bf16 vs float32 MAE {mae} > 5e-3 or max abs {max_abs} > 0.15")
    return runner, vol, launches, aff, (plan, qaff), t_dig, ckpt


def print_kernel_table(prof, wall, what):
    """The device kernels of a ``torch.profiler`` run, largest first: the
    20 largest and K1 wherever it ranks, with the device's busy share of
    ``wall`` seconds."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        # kernel and memcpy rows only: an op's row repeats its kernels' time
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile {what}: wall {wall * 1e3:.1f} ms, device kernels "
          f"{total / 1e3:.1f} ms (busy share {total / 1e6 / wall:.3f}) "
          f"[one stream: kernels do not overlap]")
    for us, count, key in [r for i, r in enumerate(rows)
                           if i < 20 or "scatter_blend" in r[2]]:
        print(f"  {us / 1e3:10.3f} ms {100 * us / total:5.1f}% "
              f"x{count:<5d} {key[:100]}")


def profile_train(trainer, data_handling, dataset):
    """Device-time breakdown of two warm train steps at full width
    (torch.profiler), the batches sampled beforehand."""
    from torch.profiler import ProfilerActivity, profile

    batches = [b for _, b in zip(range(2), data_handling.iterate_batches(
        dataset, trainer.batch_size))]
    trainer.train_batch(*batches[0], epoch=9, step=0)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step, (xs, ys) in enumerate(batches):
            trainer.train_batch(xs, ys, epoch=9, step=step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_kernel_table(prof, wall, "2 train steps")


def profile_predict(inference, runner, vol):
    """Device-time breakdown of one predict by kernel (torch.profiler),
    and the host time of its CPU-side ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference.predict(vol, runner, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print_kernel_table(prof, wall, "predict")

    from aind_exaspim_neuron_segmentation_tpu_torch.core import normalize
    from aind_exaspim_neuron_segmentation_tpu_torch.ops.stitch import (
        reflect_pad_to_grid,
    )

    t0 = time.perf_counter()
    img = np.ascontiguousarray(normalize(np.minimum(vol, 1000)), np.float32)
    t_norm = time.perf_counter() - t0
    t0 = time.perf_counter()
    reflect_pad_to_grid(img, (96,) * 3, (32,) * 3)
    t_pad = time.perf_counter() - t0
    print(f"host: clip + normalize {t_norm * 1e3:.1f} ms, reflect pad "
          f"{t_pad * 1e3:.1f} ms")


def phase_tail_build(card):
    """Build the port's C++ engine with ``g++`` and time it; print the
    compiler, the host's CPU count and whether zlib's and zstd's headers
    compile (an answer for later work, never a failure)."""
    from aind_exaspim_neuron_segmentation_tpu_torch.native import build

    cxx = subprocess.run([build.CXX, "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"tail build: {cxx.stdout.splitlines()[0]}; host "
          f"os.cpu_count() {os.cpu_count()}")
    for header in ("zlib.h", "zstd.h"):
        probe = subprocess.run(
            [build.CXX, "-fsyntax-only", "-x", "c++", "-"],
            input=f"#include <{header}>\n", capture_output=True, text=True,
            timeout=60,
        )
        print(f"tail build: <{header}> "
              f"{'compiles' if probe.returncode == 0 else 'does not compile'}")
    t0 = time.perf_counter()
    path = build.rebuild()
    build.load()
    t_build = time.perf_counter() - t0
    check(build.loaded_path() == path, "engine loaded from another path")
    print(f"tail build: engine built and loaded in "
          f"{t_build:.1f} s ({os.path.basename(path)}) "
          f"[{card}; {os.cpu_count()} CPUs]")
    return t_build


def tube_labels(shape=(256, 256, 256), n=32, radius=4, seed=0):
    """Seeded int32 labels of ``n`` straight tubes of ``radius``, along z,
    y and x in turn, each spanning the volume but 8 voxels at either end.

    Tube centres lie on two lattices 24 voxels apart, ``A`` (8 + 24 i)
    and ``B`` (20 + 24 i). Tubes along z sit at (y, x) in A x A, along y
    at (z, x) in A x B, along x at (z, y) in B x B, so tubes of two axes
    differ by 12 in the coordinate they share, and tubes of one axis by
    24: no two touch, with at least 3 voxels of background between
    them. Labels are distinct random ids, to be renumbered.
    """
    rng = np.random.default_rng(seed)
    lat_a = 8 + 24 * np.arange((shape[0] - 20) // 24)
    lat_b = lat_a + 12
    cells = {0: (lat_a, lat_a), 1: (lat_a, lat_b), 2: (lat_b, lat_b)}
    lab = np.zeros(shape, np.int32)
    ids = rng.choice(1 << 20, n, replace=False).astype(np.int32) + 1
    r = np.arange(-radius, radius + 1)
    disc = (r[:, None] ** 2 + r[None, :] ** 2) <= radius * radius
    used = {0: set(), 1: set(), 2: set()}
    for k in range(n):
        axis = k % 3
        u_lat, v_lat = cells[axis]
        while True:
            cell = (int(rng.choice(u_lat)), int(rng.choice(v_lat)))
            if cell not in used[axis]:
                used[axis].add(cell)
                break
        plane = np.zeros(tuple(s for a, s in enumerate(shape) if a != axis),
                         bool)
        u, v = cell
        plane[u - radius:u + radius + 1, v - radius:v + radius + 1] = disc
        span = [slice(None)] * 3
        span[axis] = slice(8, shape[axis] - 8)
        view = np.moveaxis(lab[tuple(span)], axis, 0)
        view[:, plane] = ids[k]
    return lab


def phase_tail_known(inference, predigest_slab, affinity_channels, card,
                     dev, tmp):
    """Known answer at 256^3: 32 separated tubes, exact affinities made
    and digested on the card; pair and float labels equal each other and
    the tubes up to renumbering; 32 SWC entries; every skeleton vertex
    inside its own segment."""
    lab = tube_labels()
    t0 = time.perf_counter()
    aff = affinity_channels(torch.from_numpy(lab).to(dev))
    plan, qaff = predigest_slab(aff)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    check(aff.shape == (3, 256, 256, 256) and aff.device.type == dev.type,
          f"affinity_channels gave {tuple(aff.shape)} on {aff.device}")

    t0 = time.perf_counter()
    seg = inference.affinities_to_segmentation((plan, qaff))
    t_pair = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg_f = inference.affinities_to_segmentation(aff)
    t_float = time.perf_counter() - t0
    check(np.array_equal(seg, seg_f), "tubes: pair labels != float labels")
    # a bijection between tube labels (and 0) and segment ids (and 0)
    pairs = np.unique(lab.astype(np.int64) << 32 | seg.astype(np.int64))
    gt_of, seg_of = pairs >> 32, pairs & 0xFFFFFFFF
    check(len(pairs) == 33 and len(np.unique(gt_of)) == 33
          and len(np.unique(seg_of)) == 33 and seg_of[gt_of == 0][0] == 0,
          f"tubes: labels are not the tubes renumbered ({len(pairs)} pairs)")
    check(int(seg.max()) == 32, f"tubes: {seg.max()} segments, not 32")

    zip_path = os.path.join(tmp, "tubes.zip")
    t0 = time.perf_counter()
    skels = inference.segmentation_to_zipped_swcs(seg, zip_path)
    t_skel = time.perf_counter() - t0
    with zipfile.ZipFile(zip_path) as zf:
        names = sorted(zf.namelist(), key=lambda s: int(s.split(".")[0]))
    check(names == [f"{i}.swc" for i in range(1, 33)],
          f"tubes: zip entries {names}")
    vox = inference.voxelize_skeletons(skels, seg.shape)
    for i in range(1, 33):
        check((vox == i).any() and (seg[vox == i] == i).all(),
              f"tubes: skeleton {i} leaves its segment")
    print(f"tail known answer (32 tubes, 256^3): affinities + digest on "
          f"the card {t_dev:.3f} s, segment pair {t_pair:.3f} s, segment "
          f"float {t_float:.3f} s, skeletonize + zip {t_skel:.3f} s; pair "
          f"== float == tubes renumbered, 32 SWC entries, vertices inside "
          f"their segments [{card}; {os.cpu_count()} CPUs]")
    return seg, zip_path


def phase_tail_main(inference, predigest_slab, aff, pair, t_predict, card,
                    dev, tmp):
    """The main path's digest pair segmented and skeletonized into a zip
    (the engine's stage times on stderr), then the leading half-size crop
    (128^3) of its float affinities digested on the card: pair labels ==
    float labels."""
    os.environ["EXA_DEBUG_TIMING"] = "1"
    try:
        t0 = time.perf_counter()
        seg = inference.affinities_to_segmentation(pair)
        t_seg = time.perf_counter() - t0
    finally:
        del os.environ["EXA_DEBUG_TIMING"]
    counts = np.bincount(seg.ravel())
    n = len(counts) - 1
    check(seg.shape == aff.shape[1:] and seg.dtype == np.uint32,
          f"main labels {seg.shape} {seg.dtype}")
    check(n > 0 and (counts[1:] > 100).all(),
          "main labels not contiguous 1..n with every segment > 100 voxels")
    zip_path = os.path.join(tmp, "main.zip")
    t0 = time.perf_counter()
    skels = inference.segmentation_to_zipped_swcs(seg, zip_path)
    t_skel = time.perf_counter() - t0
    with zipfile.ZipFile(zip_path) as zf:
        names = set(zf.namelist())
    check(names == {f"{i}.swc" for i in range(1, n + 1)}
          and set(skels) == set(range(1, n + 1)),
          f"main zip holds {len(names)} entries for {n} segments")
    print(f"tail main path ({aff.shape[1]}^3, full width, bf16 folded): "
          f"predict (predigest) {t_predict:.3f} s, segment {t_seg:.3f} s, "
          f"skeletonize + zip {t_skel:.3f} s; {n} segments, zip "
          f"{os.path.getsize(zip_path)} bytes, background "
          f"{counts[0]} voxels [{card}; {os.cpu_count()} CPUs]")

    half = aff.shape[1] // 2
    crop = np.ascontiguousarray(aff[:, :half, :half, :half])
    t0 = time.perf_counter()
    plan, qaff = predigest_slab(torch.from_numpy(crop).to(dev))
    torch.cuda.synchronize()
    t_dig = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg_p = inference.affinities_to_segmentation((plan, qaff))
    t_pair = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg_f = inference.affinities_to_segmentation(crop)
    t_float = time.perf_counter() - t0
    check(np.array_equal(seg_p, seg_f), "128^3 crop: pair labels != float")
    print(f"tail {half}^3 crop of the main affinities: digest on the card "
          f"{t_dig:.3f} s, segment pair {t_pair:.3f} s, float "
          f"{t_float:.3f} s, {int(seg_p.max())} segments, pair == float "
          f"[{card}; {os.cpu_count()} CPUs]")
    return seg, crop, seg_f


def zip_entries(path):
    """{name: bytes} of every entry of a zip."""
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def write_blosc_zarr(io, path, arr, chunks):
    """``arr`` as a zarr v2 store with AIND's production codec (blosc, lz4,
    byte shuffle); returns the seconds the write took."""
    t0 = time.perf_counter()
    io.write_zarr(path, arr, chunks=chunks, compressor={
        "id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1})
    return time.perf_counter() - t0


def phase_io_build(native, t_build, where):
    """Which codecs the engine built in phase 5 has (zstd or not, printed,
    never a failure), and a blosc round trip of a uint16 chunk."""
    from aind_exaspim_neuron_segmentation_tpu_torch.native import build

    raw = np.random.default_rng(2).integers(
        0, 1500, (64, 128, 128), dtype=np.uint16).tobytes()
    t0 = time.perf_counter()
    chunk = native.blosc_compress(raw, typesize=2, shuffle=1)
    back = native.blosc_decompress(chunk)
    t_codec = time.perf_counter() - t0
    check(back == raw, "blosc round trip differs")
    zstd = native.have_zstd()
    print(f"io build: engine of {len(build.sources())} sources built in "
          f"{t_build:.1f} s (phase 5); system zstd "
          f"{'linked' if zstd else 'absent (zstd streams raise)'} "
          f"(exa_have_zstd {int(zstd)}); blosc lz4 round trip "
          f"of a 2 MiB uint16 chunk {t_codec:.3f} s, ratio "
          f"{len(raw) / len(chunk):.2f} [{where}]")


def phase_lazy_main(inference, io, scatter, runner, vol, pair, seg_dense,
                    where, tmp):
    """The lazy main path at 256^3: blosc zarr in, digest stores out via
    ``predict``, then the streaming segmentation of the store pair."""
    from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (
        DEFAULT_PERCENTILES,
        streaming_percentile,
    )

    src = os.path.join(tmp, "vol.zarr")
    t_write = write_blosc_zarr(io, src, vol, (64, 128, 128))
    handle = io.read(src)
    t0 = time.perf_counter()
    got_pct = streaming_percentile(
        handle, DEFAULT_PERCENTILES, transform=lambda b: np.minimum(b, 1000))
    t_pct = time.perf_counter() - t0
    want_pct = np.percentile(np.minimum(vol, 1000), DEFAULT_PERCENTILES)
    print(f"lazy main path: streaming_percentile {got_pct.tolist()} vs "
          f"np.percentile {want_pct.tolist()} ({t_pct:.3f} s)")
    check(np.array_equal(got_pct, want_pct),
          "streaming percentile differs from np.percentile")

    paths = (os.path.join(tmp, "plan.zarr"), os.path.join(tmp, "qaff.zarr"))
    scatter.scatter_batch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan_h, qaff_h = inference.predict(handle, runner, verbose=False,
                                       predigest=True, out_path=paths)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    launches = scatter.scatter_batch.launches
    check(launches > 0, "lazy predict did not launch K1")
    check(np.array_equal(plan_h[:], pair[0])
          and np.array_equal(qaff_h[:], pair[1]),
          "lazy digest stores differ from the in-RAM digest pair")
    print(f"lazy main path: zarr write (blosc) {t_write:.3f} s, lazy "
          f"predict(predigest, out_path) {t_pred:.3f} s "
          f"({vol.size / t_pred / 1e6:.2f} Mvox/s), K1 launches {launches}; "
          f"stores == in-RAM digest [{where}]")

    t0 = time.perf_counter()
    seg_h = inference.affinities_to_segmentation(
        (plan_h, qaff_h), out_path=os.path.join(tmp, "seg.zarr"),
        tmp_dir=tmp, verbose=True)
    t_seg = time.perf_counter() - t0
    check(np.array_equal(seg_h[:], seg_dense),
          "streaming labels differ from the dense labels")
    print(f"lazy main path: streaming segment of the store pair {t_seg:.3f} s"
          f" (stage stamps on stderr), {int(seg_dense.max())} segments, "
          f"labels == dense [{where}]")
    return launches


def phase_lazy_float(inference, io, crop, seg_crop, where, tmp):
    """A 128^3 crop of float affinities as a zarr store: digested on the
    card inside ``segment_streaming``; labels == the crop's dense ones."""
    path = os.path.join(tmp, "aff_crop.zarr")
    t_write = write_blosc_zarr(io, path, crop, (3, 64, 128, 128))
    t0 = time.perf_counter()
    seg = inference.affinities_to_segmentation(io.read(path), tmp_dir=tmp)
    t_seg = time.perf_counter() - t0
    check(np.array_equal(seg, seg_crop),
          "lazy float labels differ from the crop's dense labels")
    print(f"lazy float path ({crop.shape[1]}^3): zarr write {t_write:.3f} s, "
          f"streaming segment with the digest on the card {t_seg:.3f} s, "
          f"{int(seg.max())} segments, labels == dense [{where}]")


def phase_lazy_teasar(inference, io, tubes, dense_zip, where, tmp):
    """Phase 6's 32-tube labels as a zarr store: the lazy TEASAR zip holds
    the dense zip's 32 entries, byte for byte."""
    path = os.path.join(tmp, "tubes.zarr")
    write_blosc_zarr(io, path, tubes, (64, 128, 128))
    zip_path = os.path.join(tmp, "tubes_lazy.zip")
    t0 = time.perf_counter()
    inference.segmentation_to_zipped_swcs(io.read(path), zip_path)
    t_skel = time.perf_counter() - t0
    got, want = zip_entries(zip_path), zip_entries(dense_zip)
    check(len(want) == 32 and got == want,
          f"lazy TEASAR zip ({len(got)} entries) differs from the dense zip")
    print(f"lazy TEASAR (32 tubes, 256^3 store): skeletonize + zip "
          f"{t_skel:.3f} s, 32 entries == dense zip [{where}]")


def phase_cli(inference, io, runner, vol, ckpt, where, tmp):
    """``python -m ... run`` on a 128^3 crop at full width, without
    ``--device``; its labels and zip equal the library path's."""
    crop = np.ascontiguousarray(vol[:128, :128, :128])
    src = os.path.join(tmp, "crop.zarr")
    write_blosc_zarr(io, src, crop, (64, 128, 128))
    work, out = os.path.join(tmp, "cli_work"), os.path.join(tmp, "cli.zip")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "aind_exaspim_neuron_segmentation_tpu_torch",
         "run", "--input", src, "--model", ckpt, "--workdir", work,
         "--output", out, "--quiet"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600,
    )
    t_cli = time.perf_counter() - t0
    check(res.returncode == 0, f"CLI run failed:\n{res.stdout}{res.stderr}")
    result = json.loads(res.stdout.strip().splitlines()[-1])

    lib = os.path.join(tmp, "lib")
    os.makedirs(lib)
    pair = inference.predict(io.read(src), runner, verbose=False,
                             predigest=True,
                             out_path=(os.path.join(lib, "plan.zarr"),
                                       os.path.join(lib, "qaff.zarr")))
    seg = inference.affinities_to_segmentation(
        pair, out_path=os.path.join(lib, "segmentation.zarr"))
    inference.segmentation_to_zipped_swcs(seg, os.path.join(lib, "o.zip"))
    check(np.array_equal(io.read(os.path.join(work, "segmentation.zarr"))[:],
                         seg[:]),
          "CLI run labels differ from the library path")
    check(zip_entries(out) == zip_entries(os.path.join(lib, "o.zip")),
          "CLI run zip differs from the library path")
    print(f"CLI run (128^3, full width, default device): {t_cli:.3f} s in "
          f"its process, stages_s {result['stages_s']}; labels and zip == "
          f"library path ({int(seg[:].max())} segments) [{where}]")


def pre_bn_bias(name):
    """Conv biases that feed a train-mode BatchNorm: BatchNorm removes
    them, so their true gradient is 0 and what is computed is noise."""
    return name.endswith(("double_conv.0.bias", "double_conv.3.bias"))


def train_batch_host(batch, size, seed):
    """NCDHW float32 patches with continuous intensities (no max-pool ties)
    and uint16 labels of a few boxes, as host arrays."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 0.5, (batch, 1) + (size,) * 3).astype(np.float32)
    y = np.zeros(x.shape, np.uint16)
    for b in range(batch):
        for label in (1, 2, 3):
            lo = rng.integers(0, size - 12, 3)
            hi = lo + rng.integers(6, 12, 3)
            y[b, 0, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = label
        x[b, 0][y[b, 0] > 0] += np.float32(0.4)
    return x, y


def float64_gradients(model, x, y):
    """Loss and gradients of one train-mode forward and backward of a
    float64 copy of ``model`` on the CPU (affinity targets, BCE mean)."""
    import copy

    from aind_exaspim_neuron_segmentation_tpu_torch.core.affinities import (
        affinity_channels,
    )

    net = copy.deepcopy(model).cpu().double().train()
    target = affinity_channels(torch.from_numpy(y.astype(np.int32))[:, 0])
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        net(torch.from_numpy(x).double()), target.double())
    loss.backward()
    return loss.item(), {n: p.grad.numpy()
                         for n, p in net.named_parameters()}


@tf32_off()
def phase_train_parity(train, dev, card, tmp):
    """(a) One float32 train step on the card against the CPU, both also
    against a float64 forward and backward of the same weights."""
    x, y = train_batch_host(2, 32, seed=4)
    out = {}
    for where in ("cpu", dev):
        tr = train.Trainer(os.path.join(tmp, f"parity_{where}"), batch_size=2,
                           width_multiplier=0.25, use_amp=False,
                           prefetch=False, device=where)
        if where == "cpu":
            l64, g64 = float64_gradients(tr.model, x, y)
        t0 = time.perf_counter()
        loss, _, _ = tr.train_batch(x, y)
        loss = float(loss)
        out[str(where)] = (loss, time.perf_counter() - t0, {
            n: p.grad.cpu().numpy() for n, p in tr.model.named_parameters()})
    (l_cpu, t_cpu, g_cpu), (l_gpu, t_gpu, g_gpu) = out["cpu"], out[str(dev)]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    top = max(np.abs(g).max() for g in g64.values())
    rows, noise = [], 0.0
    for name, t in g64.items():
        if pre_bn_bias(name):
            noise = max(noise, np.abs(g_cpu[name]).max() / top,
                        np.abs(g_gpu[name]).max() / top)
            continue
        scale = np.abs(t).max()
        rows.append((float(np.abs(g_gpu[name] - g_cpu[name]).max() / scale),
                     float(np.abs(g_gpu[name] - t).max() / scale),
                     float(np.abs(g_cpu[name] - t).max() / scale), name))
    rows.sort(reverse=True)
    worst = rows[0][0]
    print(f"train (a) f32 step, width 0.25, 32^3, batch 2, card vs CPU: loss "
          f"{l_gpu:.7f} vs {l_cpu:.7f} (rel {rel:.3e}; float64 "
          f"{l64:.7f}), worst tensor gradient {worst:.3e} of its max; "
          f"pre-BatchNorm conv-bias gradients <= {noise:.3e} of the "
          f"largest; first step {t_gpu:.3f} s card, {t_cpu:.3f} s CPU "
          f"[{card}]")
    for card_cpu, card_64, cpu_64, name in rows[:4]:
        print(f"  {name}: card-CPU {card_cpu:.3e}, card-float64 "
              f"{card_64:.3e}, CPU-float64 {cpu_64:.3e} of its max")
    check(rel <= 1e-5, f"train step loss rel {rel} > 1e-5")
    # cuDNN's float32 gradients (TF32 off) lie up to ~2.6e-4 of a
    # tensor's max from float64 here, the CPU's ~1e-5 (the rows above);
    # a missing term or a wrong scale moves a tensor by O(1) of its max
    check(worst <= 1e-3, f"train step gradient {worst} > 1e-3 of max")
    check(max(r[1] for r in rows) <= 1e-3,
          "card gradient > 1e-3 of a tensor's max from float64")
    check(noise <= 1e-6, f"pre-BatchNorm bias gradient {noise} > 1e-6")


def phase_augment_parity(augment_device, dev, card, batch=16, size=96):
    """(b) The device augmentation given fixed draws, card vs CPU, and its
    time on the card at the training shape."""
    rng = np.random.default_rng(8)
    shape = (batch, 1) + (size,) * 3
    img = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 1000, shape).astype(np.int32))
    params = augment_device.draw_augment_params(
        torch.Generator().manual_seed(5), batch, shape[2:])
    dev_params = {k: v.to(dev) for k, v in params.items()}
    img_d, lab_d = img.to(dev), lab.to(dev)
    t0 = time.perf_counter()
    gi_c, gl_c = augment_device.apply_geometric(img, lab, params)
    want = augment_device.apply_intensity(gi_c, params)
    t_cpu = time.perf_counter() - t0
    gi_g, gl_g = augment_device.apply_geometric(img_d, lab_d, dev_params)
    got = augment_device.apply_intensity(gi_g, dev_params)
    geo = torch.equal(gi_g.cpu(), gi_c) and torch.equal(gl_g.cpu(), gl_c)
    err = (got.cpu() - want).abs().max().item()
    ms, _ = cuda_ms(lambda: augment_device.apply_augment(img_d, lab_d,
                                                         dev_params),
                    iters=10, warmup=2)
    print(f"train (b) augmentation {tuple(shape)}, same draws: flips, "
          f"rotations ({int(params['rotate'].sum())} of {3 * batch} planes) "
          f"and labels {'bit-equal' if geo else 'DIFFER'} card vs CPU, "
          f"intensity max abs {err:.3e}; apply_augment {ms:.3f} ms on the "
          f"card, {t_cpu:.3f} s on the host's CPU [{card}]")
    check(geo, "augmentation: geometric transforms differ card vs CPU")
    check(err <= 1e-6, f"augmentation intensity max abs {err} > 1e-6")


def timed_train_batches(trainer):
    """Record, for every ``train_batch`` of ``trainer``, CUDA events around
    its work on the device, its host time and its loss."""
    rec = []
    inner = trainer.train_batch

    def train_batch(xs, ys, epoch=0, step=0):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = inner(xs, ys, epoch, step)
        end.record()
        rec.append((start, end, time.perf_counter() - t0, out[0]))
        return out

    trainer.train_batch = train_batch
    return rec


def cli_train(inference, io, imgs, labs, card, dev, tmp, patch, batch):
    """``python -m ... train`` in a subprocess (no ``--device``) at full
    width on ``imgs`` / ``labs`` written to blosc zarr stores, one epoch:
    its JSON line names the run directory, whose best-F1 ``.pth`` loads
    strictly into ``load_model``."""
    paths = {"images": [], "labels": []}
    for k, (img, lab) in enumerate(zip(imgs, labs)):
        for kind, arr in (("images", img), ("labels", lab)):
            path = os.path.join(tmp, f"train_{kind}_{k}.zarr")
            write_blosc_zarr(io, path, arr, (80,) + arr.shape[1:])
            paths[kind].append(path)
    out = os.path.join(tmp, "cli_train")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "aind_exaspim_neuron_segmentation_tpu_torch",
         "train", "--images", *paths["images"], "--labels",
         *paths["labels"], "--output", out, "--patch", f"{patch},{patch},"
         f"{patch}", "--batch-size", str(batch), "--epochs", "1",
         "--containment-buffer", "0"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600,
    )
    t_cli = time.perf_counter() - t0
    check(res.returncode == 0,
          f"CLI train failed:\n{res.stdout}{res.stderr}")
    log_dir = json.loads(res.stdout.strip().splitlines()[-1])["train"]
    pths = sorted(f for f in os.listdir(log_dir)
                  if f.startswith("UNet3d-") and f.endswith(".pth"))
    check(os.path.dirname(log_dir) == out and pths,
          f"CLI train wrote no best-F1 .pth under {out}: {res.stdout}")
    runner = inference.load_model(os.path.join(log_dir, pths[-1]),
                                  device=dev)
    check(runner.module.fused_bn
          and runner.module.outc.conv.weight.dtype == torch.bfloat16,
          "CLI train checkpoint did not load as bf16 folded")
    print(f"train (c) CLI train ({len(imgs)} zarr volume pairs, full width, "
          f"batch {batch}, {patch}^3, 1 epoch, default device): "
          f"{t_cli:.3f} s in its process; {pths[-1]} loads strictly into "
          f"load_model [{card}]")


def phase_train_full(train, data_handling, inference, io, scatter, card,
                     dev, tmp, n_vol=8, size=160, patch=96, batch=16,
                     width=1):
    """(c) The training main path at full width: ``Trainer.run``, then its
    best-F1 ``.pth`` through ``load_model`` and ``predict``; then the CLI
    ``train`` on the same volumes as zarr stores."""
    t0 = time.perf_counter()
    imgs, labs = [], []
    for k in range(n_vol):
        lab = tube_labels((size,) * 3, n=32 if size >= 160 else 12, seed=k)
        rng = np.random.default_rng(100 + k)
        img = rng.integers(0, 120, lab.shape).astype(np.uint16)
        img[lab > 0] += np.uint16(350)
        imgs.append(img)
        labs.append(lab)
    t_data = time.perf_counter() - t0
    shape = (patch,) * 3
    train_ds = data_handling.TrainDataset(
        imgs, labs, patch_shape=shape, seed=0, return_label_patches=True)
    val_ds = data_handling.ValidateDataset(
        imgs, labs, patch_shape=shape, containment_buffer=0)
    trainer = train.Trainer(os.path.join(tmp, "train"), batch_size=batch,
                            use_amp=True, max_epochs=2, width_multiplier=width,
                            device=dev)
    rec = timed_train_batches(trainer)
    epochs = []
    inner_epoch = trainer.train_step

    def train_step(dataset, epoch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = inner_epoch(dataset, epoch)
        torch.cuda.synchronize()
        epochs.append((time.perf_counter() - t, trainer.input_wait_s))
        return stats

    trainer.train_step = train_step
    torch.cuda.reset_peak_memory_stats()
    scatter.scatter_batch.launches = 0
    t0 = time.perf_counter()
    best = trainer.run(train_ds, val_ds)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    k1_train = scatter.scatter_batch.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(r[3]) for r in rec]
    dev_ms = [r[0].elapsed_time(r[1]) for r in rec]
    host_ms = [r[2] * 1e3 for r in rec]
    n_patches = len(train_ds)
    print(f"train (c) full width, batch {batch}, {patch}^3, bf16 autocast, "
          f"augmentation on the card ({trainer.device_augment}), raw u16 "
          f"wire ({train_ds.wire_raw_images}), label wire "
          f"({train_ds.wire_labels}): {len(rec)} steps in 2 epochs + "
          f"validation of {len(val_ds)} patches, run {t_run:.3f} s "
          f"(volumes made in {t_data:.3f} s); K1 launches in training "
          f"{k1_train} [{card}]")
    print(f"train (c) losses {[round(v, 6) for v in losses]}, best val F1 "
          f"{best:.4f}")
    print(f"train (c) step on the device (CUDA events): first "
          f"{dev_ms[0]:.1f} ms, warm median {np.median(dev_ms[1:]):.1f} ms "
          f"(all {[round(v, 1) for v in dev_ms]}); host time in "
          f"train_batch {[round(v, 1) for v in host_ms]} ms [{card}]")
    for e, (wall, wait) in enumerate(epochs):
        print(f"train (c) epoch {e}: {wall:.3f} s for {n_patches} patches "
              f"({n_patches / wall:.2f} patches/s), input_wait_s "
              f"{wait:.3f} [{card}]")
    print(f"train (c) peak device memory (max_memory_allocated) "
          f"{peak:.2f} GiB [{card}]")
    steps = 2 * -(-n_patches // batch)
    check(len(rec) == steps and all(np.isfinite(losses)),
          f"{len(rec)} training steps of {steps}, losses {losses}")
    check(trainer.device_augment and train_ds.wire_raw_images,
          "the device-augment raw-wire path was not taken")
    pths = sorted(f for f in os.listdir(trainer.log_dir)
                  if f.startswith("UNet3d-") and f.endswith(".pth"))
    check(pths, f"no best-F1 .pth written (best F1 {best})")
    runner = inference.load_model(os.path.join(trainer.log_dir, pths[-1]),
                                  device=dev, width_multiplier=width)
    check(runner.module.fused_bn
          and runner.module.outc.conv.weight.dtype == torch.bfloat16,
          "trained checkpoint did not load as bf16 folded")
    crop = np.ascontiguousarray(imgs[0][:128, :128, :128])
    scatter.scatter_batch.launches = 0
    t0 = time.perf_counter()
    aff = inference.predict(crop, runner, verbose=False,
                            patch_shape=shape, overlap=(patch // 3,) * 3)
    t_pred = time.perf_counter() - t0
    check(aff.shape == (3,) + crop.shape and np.isfinite(aff).all(),
          f"predict of the trained checkpoint: {aff.shape}, finite "
          f"{np.isfinite(aff).all()}")
    print(f"train (c) {pths[-1]} -> load_model (bf16, folded) -> predict "
          f"{crop.shape}: finite affinities, mean {aff.mean():.4f}, "
          f"{t_pred:.3f} s, K1 launches {scatter.scatter_batch.launches} "
          f"[{card}]")
    cli_train(inference, io, imgs, labs, card, dev, tmp, patch, batch)
    return k1_train, trainer, train_ds


def record_first_step(trainer):
    """Keep the gradients the optimizer's first step of ``trainer`` takes
    (on a mesh: summed over it), by parameter name, in
    ``trainer.first_grads``, as host arrays, and the logits of the
    model's first forward (this rank's rows) in ``trainer.first_logits``,
    on the card."""
    step = trainer.optimizer.step
    forward = trainer.model.forward
    trainer.first_grads = trainer.first_logits = None

    def first_forward(*args, **kwargs):
        out = forward(*args, **kwargs)
        if trainer.first_logits is None:
            trainer.first_logits = out.detach().clone()
        return out

    trainer.model.forward = first_forward

    def first(*args, **kwargs):
        if trainer.first_grads is None:
            trainer.first_grads = {
                n: p.grad.float().cpu().numpy()
                for n, p in trainer.model.named_parameters()}
        return step(*args, **kwargs)

    trainer.optimizer.step = first


def gradient_figures(got, want):
    """(worst tensor's max-abs difference over its max-abs gradient, its
    name, the pre-BatchNorm conv biases' largest gradient over the
    largest gradient) of ``got`` against ``want``."""
    top = max(np.abs(g).max() for g in want.values())
    worst, name, noise = 0.0, None, 0.0
    for key, w in want.items():
        if pre_bn_bias(key):
            noise = max(noise, np.abs(got[key]).max() / top,
                        np.abs(w).max() / top)
            continue
        rel = float(np.abs(got[key] - w).max() / np.abs(w).max())
        if rel >= worst:
            worst, name = rel, key
    return worst, name, float(noise)


def param_figure(got, want):
    """Largest per-tensor max-abs difference of two parameter sets over
    that tensor's max-abs value, and the largest absolute difference."""
    rel = absolute = 0.0
    for key, w in want.items():
        d = float(np.abs(got[key] - w).max())
        rel = max(rel, d / float(np.abs(w).max()))
        absolute = max(absolute, d)
    return rel, absolute


def forward_batch_ms(forward_batch, module, slab, starts, valid, reps=5):
    """Median device ms of ``forward_batch`` over ``reps`` timed calls
    after two warm-up calls (CUDA events around each)."""
    kw = dict(patch_shape=(96, 96, 96), trim=8)
    times = []
    with torch.inference_mode():
        for i in range(reps + 2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            forward_batch(module, slab, starts, valid, **kw)
            end.record()
            end.synchronize()
            if i >= 2:
                times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def sliced_forward(module):
    """``module`` called as the full forward sliced to the kept core: the
    path the valid-region decoder replaces."""
    def call(x, valid_trim=0):
        t = valid_trim
        return module(x)[:, :, t:-t, t:-t, t:-t]

    return call


def phase_valid_decoder(inference, runner, vol, ckpt, card, dev):
    """(a) The valid-region decoder at full width on 16 patches of the
    main volume, against the sliced full forward of the same module."""
    from aind_exaspim_neuron_segmentation_tpu_torch.core import (
        normalize,
        patch_starts_array,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.ops.stitch import (
        forward_batch,
    )

    slab = torch.from_numpy(
        normalize(np.minimum(vol, 1000)).astype(np.float32)).to(dev)
    # the first 16 patches of the grid that lie inside the volume
    # (``predict`` reflect-pads the volume for the others)
    grid = [p for p in patch_starts_array(vol.shape, (96,) * 3, (32,) * 3)
            if (p + 96 <= np.asarray(vol.shape)).all()]
    starts = torch.from_numpy(np.stack(grid[:16])).to(dev)
    valid = torch.ones(16, device=dev)
    ref = inference.load_model(ckpt, affinity_mode=True, device=dev,
                               dtype=torch.float32)
    kw = dict(patch_shape=(96, 96, 96), trim=8)
    figures = {}
    with torch.inference_mode(), tf32_off():
        for name, module in (("float32", ref.module),
                             ("bf16 folded", runner.module)):
            fast = forward_batch(module, slab, starts, valid, **kw)
            full = forward_batch(sliced_forward(module), slab, starts,
                                 valid, **kw)
            check(fast.shape == full.shape == (16, 3, 80, 80, 80),
                  f"valid-region batch {tuple(fast.shape)}")
            diff = (fast - full).abs()
            figures[name] = (float(diff.max()), float(diff.mean()))
            del fast, full, diff
    del ref
    torch.cuda.empty_cache()
    for name, (max_abs, mae) in figures.items():
        print(f"valid (a) forward_batch valid_trim=8 vs sliced full forward, "
              f"16 x 96^3, {name}: max abs {max_abs:.3e}, MAE {mae:.3e} "
              f"[{card}]")
    check(figures["float32"][1] <= 1e-5,
          f"valid-region float32 MAE {figures['float32'][1]} > 1e-5")
    ms_fast, runs_fast = forward_batch_ms(forward_batch, runner.module,
                                          slab, starts, valid)
    ms_full, runs_full = forward_batch_ms(
        forward_batch, sliced_forward(runner.module), slab, starts, valid)
    print(f"valid (a) forward_batch device time, bf16 folded, 16 x 96^3 "
          f"(median of 5): valid-region {ms_fast:.2f} ms (runs "
          f"{[round(t, 2) for t in runs_fast]}), sliced full forward "
          f"{ms_full:.2f} ms (runs {[round(t, 2) for t in runs_full]}) "
          f"[{card}]")
    return figures


def dp_trainers(train, data_handling, imgs, labs, mesh, dev, tmp, name,
                **kw):
    """A full-width bf16 Trainer (batch 16) on ``mesh`` and its datasets on
    phase 13's volumes (augmentation on the card)."""
    trainer = train.Trainer(os.path.join(tmp, name), batch_size=16,
                            use_amp=True, mesh=mesh, device=dev, **kw)
    train_ds = data_handling.TrainDataset(
        imgs, labs, patch_shape=(96, 96, 96), seed=0,
        return_label_patches=True)
    val_ds = data_handling.ValidateDataset(
        imgs, labs, patch_shape=(96, 96, 96), containment_buffer=0)
    return trainer, train_ds, val_ds


@tf32_off()
def float32_dp_step(train, mesh, dev, tmp, name, exact=False):
    """One float32 train step (TF32 off) at phase 13 (a)'s size (width
    0.25, 32^3) on a host batch of 4 every rank sees; returns its
    first-step gradients and, with ``exact``, the float64 gradients of
    the same weights on the CPU."""
    trainer = train.Trainer(os.path.join(tmp, name), batch_size=4,
                            width_multiplier=0.25, use_amp=False,
                            prefetch=False, mesh=mesh, device=dev)
    x, y = train_batch_host(4, 32, seed=7)
    # the float64 copy first: a copy made after record_first_step would
    # carry its wrapped forward
    exact = float64_gradients(trainer.model, x, y)[1] if exact else None
    record_first_step(trainer)
    trainer.train_batch(x, y)
    return trainer.first_grads, exact


def one_process_reference(train, data_handling, imgs, labs, dev, tmp, name,
                          sync):
    """The first step of one process without a mesh, full width, bf16,
    batch 16, phase 13's volumes and seed: its gradients, its first
    forward's logits and its loss. ``sync``: its BatchNorms are the
    synchronized ones over the whole batch (the function (c)'s ranks
    compute); else cuDNN's."""
    from aind_exaspim_neuron_segmentation_tpu_torch.parallel.sync_batchnorm import (  # noqa: E501
        convert_sync_batchnorm,
    )

    trainer, train_ds, _ = dp_trainers(train, data_handling, imgs, labs,
                                       None, dev, tmp, name, max_epochs=1)
    if sync:
        convert_sync_batchnorm(trainer.model, None)
    rec = timed_train_batches(trainer)
    record_first_step(trainer)
    trainer.train_step(train_ds, 0)
    loss = float(rec[0][3])
    check(np.isfinite(loss), f"{name}: loss {loss}")
    out = dict(grads=trainer.first_grads, logits=trainer.first_logits,
               loss=loss)
    del trainer
    torch.cuda.empty_cache()
    return out


def dp_figures(got, want):
    """How far one first step lies from another: the logits' mean
    absolute difference, the loss's relative difference, the gradients'
    relative L2 difference over all tensors and its median over the
    tensors (pre-BatchNorm conv biases left out), and the worst tensor's
    max-abs difference over its max-abs gradient."""
    g, w = got["grads"], want["grads"]
    keys = [k for k in w if not pre_bn_bias(k)]
    l2 = [float(np.linalg.norm(g[k] - w[k]) / np.linalg.norm(w[k]))
          for k in keys]
    flat = [np.concatenate([d[k].ravel() for k in keys]) for d in (g, w)]
    return dict(
        logits_mae=float((got["logits"].float()
                          - want["logits"].float()).abs().mean()),
        loss_rel=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
        grad_l2=float(np.linalg.norm(flat[0] - flat[1])
                      / np.linalg.norm(flat[1])),
        grad_l2_median=float(np.median(l2)),
        grad_max_abs=gradient_figures(g, w)[0])


def format_figures(fig):
    return ", ".join(f"{k} {v:.3e}" for k, v in fig.items())


def phase_dp_world1(train, data_handling, imgs, labs, card, dev, tmp):
    """(b) ``Trainer(mesh=make_mesh())`` on one NCCL rank (two bf16
    steps), then (c)'s references: the first step of one process with
    the synchronized BatchNorm, run twice, and with cuDNN's; the float32
    reference step with its float64 gradients. Returns the references."""
    import torch.distributed as dist

    from aind_exaspim_neuron_segmentation_tpu_torch import parallel
    from aind_exaspim_neuron_segmentation_tpu_torch.parallel.sync_batchnorm import (  # noqa: E501
        SyncBatchNorm3d,
    )

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        trainer, train_ds, _ = dp_trainers(
            train, data_handling, imgs, labs, parallel.make_mesh(), dev, tmp,
            "dp_world1", max_epochs=1)
        check(trainer._rows is None and not any(
            isinstance(m, SyncBatchNorm3d) for m in trainer.model.modules()),
            "a mesh of one rank changed the Trainer's step")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = trainer.train_step(train_ds, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(np.isfinite(stats["loss"]), f"world-1 mesh loss {stats}")
        del trainer
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"dp (b) Trainer(mesh=make_mesh()), 1 NCCL rank: native "
          f"BatchNorm, no collective (the step without a mesh); full width, "
          f"batch 16, 96^3, bf16, augmentation on the card, 2 steps "
          f"{wall:.3f} s, mean loss {stats['loss']:.6f} [{card}]")
    refs = {name: one_process_reference(train, data_handling, imgs, labs,
                                        dev, tmp, f"dp_{name}", sync)
            for name, sync in (("sync", True), ("sync_again", True),
                               ("cudnn", False))}
    again = dp_figures(refs["sync_again"], refs["sync"])
    swap = dp_figures(refs["cudnn"], refs["sync"])
    print(f"dp (b) one process without a mesh, full width, batch 16, bf16, "
          f"first step; a second run with the synchronized BatchNorm vs the "
          f"first: {format_figures(again)}; cuDNN's BatchNorm vs the "
          f"synchronized: {format_figures(swap)} [{card}]")
    ref, exact = float32_dp_step(train, None, dev, tmp, "dp_f32_alone",
                                 exact=True)
    worst, name, _ = gradient_figures(ref, exact)
    print(f"dp (b) float32 reference step (no mesh, TF32 off, width 0.25, "
          f"4 x 32^3 host batch): worst {worst:.3e} of the tensor's max "
          f"from float64 ({name}) [{card}]")
    return dict(f32=ref, f64=exact, f32_from_f64=worst, bf16=refs["sync"],
                bf16_swap=swap)


def dp_rank(tmp):
    """One rank of phase 15 (c), run as ``chip_smoke.py --dp-rank TMP``
    with the job in its environment: the float32 step on the mesh of both
    ranks, then ``Trainer.run`` for 2 epochs of 2 steps at full width;
    its figures go to ``TMP/dp_rank<r>.json``, both runs' first-step
    gradients and the final state to ``TMP/dp_rank<r>.pt``."""
    import torch.distributed as dist

    from aind_exaspim_neuron_segmentation_tpu_torch import parallel
    from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
        data_handling,
        train,
    )

    check(parallel.initialize_distributed(), "no two-rank job")
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = parallel.make_mesh(2)
    data = np.load(os.path.join(tmp, "train_vols.npz"))
    imgs = [data[f"img{k}"] for k in range(len(data.files) // 2)]
    labs = [data[f"lab{k}"] for k in range(len(data.files) // 2)]
    grads, _ = float32_dp_step(train, mesh, dev, tmp, f"dp_f32_r{rank}")
    out = dict(rank=rank, backend=dist.get_backend())

    trainer, train_ds, val_ds = dp_trainers(
        train, data_handling, imgs, labs, mesh, dev, tmp, f"dp_r{rank}",
        max_epochs=2)
    rec = timed_train_batches(trainer)
    record_first_step(trainer)
    epochs = []
    inner_epoch = trainer.train_step

    def train_step(dataset, epoch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = inner_epoch(dataset, epoch)
        torch.cuda.synchronize()
        epochs.append((time.perf_counter() - t, trainer.input_wait_s))
        return stats

    trainer.train_step = train_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out["best_f1"] = trainer.run(train_ds, val_ds)
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["step_ms"] = [r[0].elapsed_time(r[1]) for r in rec]
    out["losses"] = [float(r[3]) for r in rec]
    out["epochs"] = epochs
    out["patches"] = len(train_ds)
    state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    torch.save({
        "f32": {k: torch.from_numpy(g) for k, g in grads.items()},
        "bf16": {k: torch.from_numpy(g)
                 for k, g in trainer.first_grads.items()},
        "logits": trainer.first_logits.cpu(),
        "state": state}, os.path.join(tmp, f"dp_rank{rank}.pt"))
    with open(os.path.join(tmp, f"dp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def phase_data_parallel(train, data_handling, train_ds, card, dev, tmp):
    """Phase 15 (b)-(d): data-parallel training on one NCCL rank, on two
    gloo ranks of this script, and through the CLI's ``train
    --distributed``."""
    t_phase = time.perf_counter()
    imgs, labs = train_ds.input_imgs, train_ds.label_masks
    ref = phase_dp_world1(train, data_handling, imgs, labs, card, dev, tmp)

    # (c) two gloo ranks on the one card
    np.savez(os.path.join(tmp, "train_vols.npz"),
             **{f"img{k}": a for k, a in enumerate(imgs)},
             **{f"lab{k}": a for k, a in enumerate(labs)})
    t0 = time.perf_counter()
    join(spawn([sys.executable, os.path.abspath(__file__), "--dp-rank",
                tmp], 2, "jax", tmp, "dp"), tmp, "dp", 900)
    t_c = time.perf_counter() - t0
    results, saved = [], []
    for rank in (0, 1):
        with open(os.path.join(tmp, f"dp_rank{rank}.json")) as f:
            results.append(json.load(f))
        saved.append(torch.load(os.path.join(tmp, f"dp_rank{rank}.pt")))
    for key, value in saved[0]["state"].items():
        check(torch.equal(saved[1]["state"][key], value),
              f"ranks differ in {key} after the data-parallel run")
    got = {k: g.numpy() for k, g in saved[0]["f32"].items()}
    worst, name, noise = gradient_figures(got, ref["f32"])
    worst64, name64, _ = gradient_figures(got, ref["f64"])
    print(f"dp (c) 2 gloo ranks, float32 step (TF32 off, width 0.25, 2 of "
          f"4 x 32^3 a rank): gradients worst {worst:.3e} of the tensor's "
          f"max from one process ({name}), {worst64:.3e} from float64 "
          f"({name64}), pre-BatchNorm biases <= {noise:.3e} [{card}]")
    check(worst <= 1e-3, f"two-rank gradient {worst} > 1e-3 of max")
    # no farther from float64 than the train bar, or than twice what one
    # float32 process lies from it
    bar64 = max(1e-3, 2 * ref["f32_from_f64"])
    check(worst64 <= bar64, f"two-rank gradient {worst64} > {bar64} of max "
          "from float64")
    check(noise <= 1e-5, f"pre-BatchNorm bias gradient {noise} > 1e-5")
    # the ranks' first step as one: the gradients are summed already, the
    # logits are the ranks' blocks of rows, the loss their shares' sum
    ranks = dict(grads={k: g.numpy() for k, g in saved[0]["bf16"].items()},
                 logits=torch.cat([s["logits"] for s in saved]),
                 loss=sum(r["losses"][0] for r in results))
    fig = dp_figures(ranks, {k: v.cpu() if k == "logits" else v
                             for k, v in ref["bf16"].items()})
    print(f"dp (c) full width, bf16, the run's first step vs (b)'s one "
          f"process with the synchronized BatchNorm on the same global "
          f"batch: {format_figures(fig)} (one process, cuDNN's BatchNorm "
          f"vs the synchronized: {format_figures(ref['bf16_swap'])}) "
          f"[{card}]")
    # Any change to the rounding of a bf16 forward moves the logits by
    # bf16 ulps and flips max-pool and LeakyReLU routes, so no 1e-3 bar
    # holds between two forwards that round differently: the batch
    # split must move the step no more than twice what swapping the
    # BatchNorm's implementation in one process moves it
    for key in ("logits_mae", "loss_rel", "grad_l2", "grad_l2_median"):
        bar = 2 * ref["bf16_swap"][key]
        check(fig[key] <= bar, f"two-rank bf16 {key} {fig[key]} > {bar} "
              "(twice one process's BatchNorm swap)")
    for r in results:
        ms = r["step_ms"]
        print(f"dp (c) rank {r['rank']} of 2 ({r['backend']}, one card), "
              f"full width, global batch 16, 96^3, bf16, augmentation on "
              f"the card: run {r['run_s']:.3f} s for 2 epochs + validation; "
              f"step on the device first {ms[0]:.1f} ms, warm median "
              f"{np.median(ms[1:]):.1f} ms (all {[round(v, 1) for v in ms]}); "
              f"peak {r['peak_gib']:.2f} GiB [{card}]")
        for e, (wall, wait) in enumerate(r["epochs"]):
            print(f"dp (c) rank {r['rank']} epoch {e}: {wall:.3f} s for "
                  f"{r['patches']} patches ({r['patches'] / wall:.2f} "
                  f"patches/s of the global batch), input_wait_s {wait:.3f} "
                  f"[{card}]")
    check(all(np.isfinite(r["losses"]).all() and len(r["losses"]) == 4
              for r in results), "two-rank losses")
    print(f"dp (c) two ranks {t_c:.3f} s with start-up; parameters and "
          f"BatchNorm buffers equal on both ranks ({len(saved[0]['state'])} "
          f"tensors) [{card}]")

    # (d) the CLI, two processes
    out = os.path.join(tmp, "cli_dp")
    stores = {kind: [os.path.join(tmp, f"train_{kind}_{k}.zarr")
                     for k in range(len(imgs))]
              for kind in ("images", "labels")}
    t0 = time.perf_counter()
    logs = join(spawn(
        [sys.executable, "-m", "aind_exaspim_neuron_segmentation_tpu_torch",
         "train", "--distributed", "--images", *stores["images"],
         "--labels", *stores["labels"], "--output", out, "--patch",
         "96,96,96", "--batch-size", "4", "--epochs", "1",
         "--containment-buffer", "0"], 2, "torchrun", tmp, "cli_dp"),
        tmp, "cli_dp", 600)
    t_d = time.perf_counter() - t0
    lines = [ln for log in logs for ln in log.splitlines()
             if ln.startswith("{")]
    check(len(lines) == 1 and lines[0] in logs[0],
          f"CLI train --distributed printed {len(lines)} result lines")
    run0 = json.loads(lines[0])["train"]
    rank1 = os.path.join(out, ".rank1")
    check(os.path.dirname(run0) == out and os.path.isdir(rank1)
          and os.listdir(rank1), f"CLI train --distributed: {run0}, "
          f"{rank1}")
    print(f"dp (d) CLI train --distributed, 2 processes (patch 96, batch 4, "
          f"1 epoch, full width): {t_d:.3f} s with start-up; one JSON line "
          f"({os.path.basename(run0)}), rank 1's run under .rank1 "
          f"({os.listdir(rank1)}) [{card}]")
    print(f"data-parallel phase {time.perf_counter() - t_phase:.3f} s "
          f"[{card}]")



def free_port():
    """A free localhost TCP port."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_env(rank, world, port, contract):
    """Environment of rank ``rank`` of a local job: the JAX package's
    names (``"jax"``) or torchrun's; gloo, since the ranks share one card
    (NCCL refuses two ranks on one device)."""
    env = dict(os.environ, EXA_DIST_BACKEND="gloo")
    if contract == "jax":
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(rank))
    else:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank))
    return env


def rank_k1_case(rng, slab):
    """The first batch of a rank's slab of the main path: a Z row of 4x4
    patches of 96^3 (trim 8) into the (3,) + ``slab`` accumulator."""
    grid = range(0, 256 - 96 + 64, 64)
    starts = np.array([(0, y, x) for y in grid for x in grid], np.int32)
    return (
        rng.standard_normal((3,) + tuple(slab)).astype(np.float32),
        rng.random((16, 3, 80, 80, 80), dtype=np.float32),
        starts, 8,
    )


def sharded_rank(tmp):
    """One rank of phase 14 (b), run as ``chip_smoke.py --sharded-rank
    TMP`` with the job in its environment: ``predict_sharded`` of the
    main volume's zarr store into a shared store (K1's launches counted
    around it, then K1 held to its plain loop at this rank's slab shape),
    ``segment_streaming_sharded`` of phase 9's digest stores and
    ``skeletonize_sharded`` of phase 11's tube store; its figures go to
    ``TMP/sharded_rank<r>.json``."""
    import torch.distributed as dist

    from aind_exaspim_neuron_segmentation_tpu_torch import (
        inference,
        io,
        parallel,
        postprocess,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.ops import scatter
    from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import (
        StageTimer,
    )

    check(parallel.initialize_distributed(), "no two-rank job")
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = dict(rank=rank, backend=dist.get_backend())
    runner = inference.load_model(os.path.join(tmp, "unet3d_seeded.pth"),
                                  device=dev)
    timer = StageTimer()
    scatter.scatter_batch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parallel.predict_sharded(
        io.read(os.path.join(tmp, "vol.zarr")), runner,
        mesh=parallel.make_mesh(), timer=timer,
        out_path=os.path.join(tmp, "sharded_aff.zarr"))
    torch.cuda.synchronize()
    out["predict_s"] = time.perf_counter() - t0
    out["k1_launches"] = scatter.scatter_batch.launches
    out["stages_s"] = timer.as_dict()
    err, vec, _ = k1_check(scatter, dev, f"rank {rank} slab",
                           rank_k1_case(np.random.default_rng(rank),
                                        (160, 288, 288)))
    out["k1_max_abs_err"], out["k1_vec"] = err, vec

    t0 = time.perf_counter()
    seg_stats = {}
    postprocess.segment_streaming_sharded(
        (io.read(os.path.join(tmp, "plan.zarr")),
         io.read(os.path.join(tmp, "qaff.zarr"))),
        out_path=os.path.join(tmp, "sharded_seg.zarr"), tmp_dir=tmp,
        stats_out=seg_stats)
    out["segment_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sk_stats = {}
    postprocess.skeletonize_sharded(
        io.read(os.path.join(tmp, "tubes.zarr")),
        zip_path=os.path.join(tmp, "sharded_tubes.zip"),
        stats_out=sk_stats)
    out["skeletonize_s"] = time.perf_counter() - t0
    out["segment_protocol"] = seg_stats.get("ranks")
    out["swc_protocol"] = sk_stats.get("ranks")
    with open(os.path.join(tmp, f"sharded_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def spawn(argv, world, contract, tmp, name):
    """Start ``world`` local processes of ``argv`` (stdout and stderr to
    ``TMP/<name>.r<rank>.log``); returns them."""
    port = free_port()
    procs = []
    for rank in range(world):
        log = open(os.path.join(tmp, f"{name}.r{rank}.log"), "w")
        procs.append(subprocess.Popen(
            argv, cwd=os.path.dirname(os.path.abspath(__file__)),
            env=rank_env(rank, world, port, contract), stdout=log,
            stderr=subprocess.STDOUT))
        log.close()
    return procs


def join(procs, tmp, name, timeout):
    """Wait for the processes (all killed past ``timeout`` s); fail unless
    each exited 0. Returns their logs."""
    deadline = time.perf_counter() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(deadline - time.perf_counter(),
                                            1)))
        except subprocess.TimeoutExpired:
            codes.append("timeout")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    logs = []
    for rank in range(len(procs)):
        with open(os.path.join(tmp, f"{name}.r{rank}.log")) as f:
            logs.append(f.read())
    check(all(c == 0 for c in codes),
          f"{name} ranks exited {codes}:\n" + "\n".join(
              f"--- rank {r}:\n{log[-4000:]}" for r, log in enumerate(logs)))
    return logs


@tf32_off()
def phase_sharded(inference, io, scatter, runner, vol, aff, seg_main,
                  tubes_zip, ckpt, card, dev, tmp):
    """Phase 14, the multi-rank path: (a) ``predict_sharded`` at world size
    1 over NCCL against phase 4's ``predict``; (b) two gloo ranks on the
    card: ``predict_sharded`` into a shared store against (a),
    ``segment_streaming_sharded`` and ``skeletonize_sharded`` against
    phases 9 and 11; (c) the CLI ``run --distributed`` in two processes
    against phase 12's ``run``, at the same time as (b). Returns K1's
    launches in (a)."""
    import torch.distributed as dist

    from aind_exaspim_neuron_segmentation_tpu_torch import parallel
    from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (
        DEFAULT_PERCENTILES,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.ops.predigest import (
        predigest_slab,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.parallel import stats
    from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import (
        StageTimer,
    )

    t_phase = time.perf_counter()
    # (a) one rank, NCCL
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(1)
        clipped = np.minimum(vol, 1000)
        ks, q_plan = stats.rank_plan(vol.size, DEFAULT_PERCENTILES)
        order = stats.order_stats_sharded(
            torch.from_numpy(clipped.astype(np.float32)).to(dev), ks, mesh)
        got_pct = stats.lerp_plan(order.cpu().numpy(), q_plan)
        want_pct = np.percentile(clipped, DEFAULT_PERCENTILES)
        check(np.array_equal(got_pct, want_pct),
              f"mesh order stats {got_pct} != np.percentile {want_pct}")
        timer = StageTimer()
        scatter.scatter_batch.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = parallel.predict_sharded(vol, runner, mesh=mesh,
                                           timer=timer)
        torch.cuda.synchronize()
        t_a = time.perf_counter() - t0
        launches = scatter.scatter_batch.launches
        t0 = time.perf_counter()
        plan, qaff = parallel.predict_sharded(vol, runner, mesh=mesh,
                                              predigest=True)
        torch.cuda.synchronize()
        t_dig = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    err_a = float(np.abs(sharded - aff).max())
    check(launches > 0, "predict_sharded did not launch K1")
    check(err_a <= 1e-6, f"predict_sharded max abs {err_a} from predict")
    want_plan, want_q = (t.cpu().numpy() for t in predigest_slab(
        torch.from_numpy(sharded).to(dev)))
    check(np.array_equal(plan, want_plan) and np.array_equal(qaff, want_q),
          "predict_sharded digest differs from the digest of its floats")
    print(f"sharded (a) world 1, NCCL, 256^3 full width bf16: "
          f"predict_sharded {t_a:.3f} s (stages "
          f"{ {k: round(v, 3) for k, v in timer.as_dict().items()} }), "
          f"max abs {err_a:.3e} from predict; predigest=True {t_dig:.3f} s, "
          f"bytes == digest of its floats; order stats {got_pct} == "
          f"np.percentile; K1 launches {launches} [{card}]")

    # (b) and (c): two gloo ranks each, at the same time
    t0 = time.perf_counter()
    ranks = spawn([sys.executable, os.path.abspath(__file__),
                   "--sharded-rank", tmp], 2, "jax", tmp, "sharded")
    cli_work, cli_zip = (os.path.join(tmp, "cli_dist"),
                         os.path.join(tmp, "cli_dist.zip"))
    cli = spawn([sys.executable, "-m",
                 "aind_exaspim_neuron_segmentation_tpu_torch", "run",
                 "--distributed", "--input", os.path.join(tmp, "crop.zarr"),
                 "--model", ckpt, "--workdir", cli_work, "--output",
                 cli_zip, "--quiet"], 2, "torchrun", tmp, "cli_dist")
    cli_logs = join(cli, tmp, "cli_dist", 600)
    t_c = time.perf_counter() - t0
    join(ranks, tmp, "sharded", 600)
    t_b = time.perf_counter() - t0

    results = []
    for rank in (0, 1):
        with open(os.path.join(tmp, f"sharded_rank{rank}.json")) as f:
            results.append(json.load(f))
    store = io.read(os.path.join(tmp, "sharded_aff.zarr"))[:]
    err_b = float(np.abs(store - sharded).max())
    check(err_b <= 1e-6, f"two-rank store max abs {err_b} from (a)")
    check(all(r["k1_launches"] > 0 for r in results),
          f"a rank launched no K1: {[r['k1_launches'] for r in results]}")
    seg = io.read(os.path.join(tmp, "sharded_seg.zarr"))[:]
    check(np.array_equal(seg, seg_main),
          "two-rank segment_streaming_sharded labels != phase 9's")
    got_zip = zip_entries(os.path.join(tmp, "sharded_tubes.zip"))
    check(got_zip == zip_entries(tubes_zip) and len(got_zip) == 32,
          "two-rank skeletonize_sharded zip != phase 11's")
    for r in results:
        print(f"sharded (b) rank {r['rank']} of 2 ({r['backend']}, one "
              f"card): predict_sharded {r['predict_s']:.3f} s (stages "
              f"{ {k: round(v, 3) for k, v in r['stages_s'].items()} }), "
              f"K1 launches {r['k1_launches']}, K1 at the rank's slab vec "
              f"{r['k1_vec']} == plain loop; segment {r['segment_s']:.3f} s,"
              f" skeletonize + zip {r['skeletonize_s']:.3f} s [{card}]")
    print(f"sharded (b) protocol: segment {results[0]['segment_protocol']};"
          f" swc {results[0]['swc_protocol']}")
    print(f"sharded (b) two ranks {t_b:.3f} s wall with their start-up: "
          f"store max abs {err_b:.3e} from (a), labels == phase 9's "
          f"({int(seg_main.max())} segments), 32 zip entries == phase 11's "
          f"[{card}]")

    lines = [ln for log in cli_logs for ln in log.splitlines()
             if ln.startswith("{")]
    check(len(lines) == 1, f"CLI run --distributed printed {len(lines)} "
          f"result lines:\n{cli_logs}")
    result = json.loads(lines[0])
    check(zip_entries(cli_zip) == zip_entries(os.path.join(tmp, "cli.zip")),
          "CLI run --distributed zip differs from phase 12's run")
    check(np.array_equal(
        io.read(os.path.join(cli_work, "segmentation.zarr"))[:],
        io.read(os.path.join(tmp, "cli_work", "segmentation.zarr"))[:]),
        "CLI run --distributed labels differ from phase 12's run")
    print(f"sharded (c) CLI run --distributed, 2 processes (128^3, full "
          f"width): {t_c:.3f} s with start-up, stages_s "
          f"{result['stages_s']}; one JSON line; labels and zip == phase "
          f"12's run [{card}]")
    print(f"sharded phase {time.perf_counter() - t_phase:.3f} s [{card}]")
    return launches


def start_module(module, args, tmp, name):
    """Start ``python -m <port>.<module> args`` from the checkout's root
    (no ``--device``: the card), its output to ``TMP/<name>.log``."""
    log = os.path.join(tmp, f"{name}.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{PORT}.{module}", *map(str, args)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=f,
            stderr=subprocess.STDOUT)
    return proc, log, time.perf_counter()


def finish_module(started, name, timeout):
    """Wait for a :func:`start_module` process (killed past ``timeout``
    s); fail unless it exited 0. Returns its output, its last line as
    JSON and its wall seconds."""
    proc, log, t0 = started
    try:
        code = proc.wait(timeout=max(timeout - (time.perf_counter() - t0),
                                     1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        code = "timeout"
    wall = time.perf_counter() - t0
    with open(log) as f:
        out = f.read()
    check(code == 0, f"{name} exited {code}:\n{out[-6000:]}")
    return out, json.loads(out.strip().splitlines()[-1]), wall


@tf32_off()
def phase_entry(card, dev):
    """Phase 16 (a): ``entry()`` on the card, its bf16 output held to the
    same seeded module in float32 (TF32 off), and its warm time."""
    from aind_exaspim_neuron_segmentation_tpu_torch.entry import entry
    from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
        UNet3D,
        init_weights,
    )

    forward_step, (module, x) = entry()
    check(module.outc.conv.weight.dtype == torch.bfloat16
          and not module.training and x.device.type == "cuda",
          "entry() module is not bf16 eval on the card")
    got = forward_step(module, x)
    check(tuple(got.shape) == (1, 3, 96, 96, 96)
          and got.dtype == torch.float32, f"entry() output {got.shape}")
    check(bool(torch.isfinite(got).all()) and got.min() >= 0
          and got.max() <= 1, "entry() output non-finite or out of [0, 1]")
    ref = UNet3D(output_channels=3)
    init_weights(ref, torch.Generator().manual_seed(0))
    want = forward_step(ref.to(dev).eval(), x)
    diff = (got - want).abs()
    mae, max_abs = float(diff.mean()), float(diff.max())
    times = []
    for i in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        forward_step(module, x)
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    print(f"entry (a) forward_step, bf16 full width, 1 x 96^3: vs float32 "
          f"(TF32 off) MAE {mae:.3e}, max abs {max_abs:.3e}; output mean "
          f"{float(got.mean()):.4f}; warm {np.median(times):.3f} ms median "
          f"of 5 (runs {[round(t, 3) for t in times]}) [{card}]")
    check(mae <= 5e-3 and max_abs <= 0.15,
          f"entry() bf16 vs float32 MAE {mae} > 5e-3 or max abs {max_abs}")
    del module, ref
    torch.cuda.empty_cache()


def phase_dryrun(card):
    """Phase 16 (b): ``dryrun_multichip(8)``, eight gloo ranks on the
    card; returns each rank's K1 launches."""
    from aind_exaspim_neuron_segmentation_tpu_torch.entry import (
        dryrun_multichip,
    )

    t0 = time.perf_counter()
    fig = dryrun_multichip(8, timeout=600)
    wall = time.perf_counter() - t0
    check(fig["mesh2"] == [4, 2] and fig["aff_2d"] == [3, 48, 44, 20],
          f"dryrun meshes {fig}")
    check(sum(fig["k1_launches"]) > 0,
          f"dryrun phase 3 launched no K1: {fig['k1_launches']}")
    print(f"entry (b) dryrun_multichip(8), 8 gloo ranks on one card: loss "
          f"{fig['loss']:.4f}, {fig['n_segments']} segments and "
          f"{fig['n_skeletons']} skeletons bit-identical (phases 4-5), K1 "
          f"launches per rank {fig['k1_launches']}; {wall:.3f} s with "
          f"start-up [{card}]")
    return fig["k1_launches"]


EXAMPLES = ("run_pipeline", "run_beyond_ram", "run_multichip")


def start_examples(tmp):
    """Phase 16 (c), started: the three examples as subprocesses on the
    card (no ``--device``), at the same time."""
    return {n: start_module(f"examples.{n}", [os.path.join(tmp, n)], tmp, n)
            for n in EXAMPLES}


def phase_examples(inference, io, card, started):
    """Phase 16 (c): each example of :func:`start_examples` exits 0 and
    its result is checked; returns K1's launches in each."""
    from aind_exaspim_neuron_segmentation_tpu_torch.examples.run_pipeline import (  # noqa: E501
        synthetic_brain,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.utils import img_util

    _, lab = synthetic_brain()
    ids = np.unique(inference.affinities_to_segmentation(
        img_util.get_affinity_channels(lab).astype(np.float32)))
    results = {}
    for n in EXAMPLES:
        _, res, wall = finish_module(started[n], n, 900)
        results[n] = res
        print(f"entry (c) examples.{n}: exit 0 in {wall:.3f} s, K1 "
              f"launches {res['k1_launches']}; result {res} [{card}]")

    pipe = results["run_pipeline"]
    names = set(zip_entries(pipe["zip"]))
    check(names == {f"{i}.swc" for i in ids[ids > 0]},
          f"run_pipeline zip {sorted(names)} != segments {ids}")
    ram = results["run_beyond_ram"]
    aff = io.read(ram["affinities"])[:]
    dense = inference.affinities_to_segmentation(aff)
    check(np.array_equal(io.read(ram["segmentation"])[:], dense),
          "run_beyond_ram label store != dense labels of its affinities")
    multi = results["run_multichip"]
    check(multi["max_abs_1d"] <= 1e-6,
          f"run_multichip 1-D max abs {multi['max_abs_1d']} > 1e-6")
    launches = dict(run_pipeline=pipe["k1_launches"],
                    run_beyond_ram=ram["k1_launches"],
                    run_multichip=multi["k1_launches"])
    check(pipe["k1_launches"] > 0 and ram["k1_launches"] > 0
          and sum(multi["k1_launches"]) > 0,
          f"an example launched no K1: {launches}")
    print(f"entry (c) run_pipeline zip == its {len(names)} segment ids; "
          f"run_beyond_ram labels == dense labels ({int(dense.max())} "
          f"segments, {ram['n_skeletons']} skeletons); run_multichip 1-D "
          f"max abs {multi['max_abs_1d']:.3e} from predict [{card}]")
    return launches


def phase_proof(card, tmp, n=PROOF_N):
    """Phase 16 (d): ``tools.beyond_ram_proof`` at ``n``^3, one process
    and then ``--ranks 2`` on the same store (the tool asserts the two
    zips entry-identical)."""
    work = os.path.join(tmp, "proof")
    out, single, _ = finish_module(start_module(
        "tools.beyond_ram_proof", [n, work], tmp, "proof_single"),
        "beyond_ram_proof", 900)
    out_r, ranks, _ = finish_module(start_module(
        "tools.beyond_ram_proof", [n, work, "--ranks", 2], tmp,
        "proof_ranks"), "beyond_ram_proof --ranks 2", 900)
    for line in (out + out_r).splitlines():
        if " cur=" in line or line.startswith("PEAK RSS"):
            print(f"entry (d) {line}")
    check(ranks["entry_identical"] is True
          and ranks["n_skeletons"] == single["n_skeletons"] > 0,
          f"proof zips: {single} / {ranks}")
    for res in (single, ranks):
        print(f"entry (d) beyond_ram_proof N={n} ranks {res['ranks']}: "
              f"walls {res['walls_s']}, peak RSS {res['peak_rss_gb']:.3f} "
              f"GB, {res['n_skeletons']} skeletons [{card}; "
              f"{os.cpu_count()} CPUs]")
    print(f"entry (d) the --ranks 2 zip is entry-identical to the "
          f"single-process zip ({ranks['n_skeletons']} entries)")


def phase_audit(card, tmp):
    """Phase 16 (e): ``tools.traffic_audit`` at batch 16, trim 0 and 8;
    prints each table and the measured/minimal ratio."""
    for trim in (0, 8):
        out, fig, wall = finish_module(start_module(
            "tools.traffic_audit", ["--batch", 16, "--trim", trim, "--top",
                                    25], tmp, f"audit{trim}"),
            f"traffic_audit --trim {trim}", 600)
        table = out[out.index("# Device-memory traffic audit"):]
        print(table.rsplit("\n", 2)[0])
        check(fig["measured_gb"] > 0 and fig["op_ms"] > 0,
              f"traffic audit found no device work: {fig}")
        print(f"entry (e) traffic_audit B=16 trim {trim}: measured "
              f"{fig['measured_gb']:.3f} GB/iter, minimal "
              f"{fig['minimal_gb']:.3f} GB, ratio {fig['ratio']:.3f}x, op "
              f"device time {fig['op_ms']:.3f} ms/iter (+{fig['orphan_ms']:.3f}"
              f" ms of kernels with no aten parent); {wall:.3f} s [{card}]")


def phase_entry_points(inference, io, card, dev, tmp):
    """Phase 16: the entry points, the examples and the tools on the
    card; returns K1's launches on the dry run and in the examples."""
    t_phase = time.perf_counter()
    stamps = {}
    t0 = time.perf_counter()
    phase_entry(card, dev)
    phase_audit(card, tmp)
    stamps["entry_and_audit_s"] = time.perf_counter() - t0
    # (b) and (c) at the same time: both are checks, not timings
    t0 = time.perf_counter()
    started = start_examples(tmp)
    try:
        dryrun = phase_dryrun(card)
        examples = phase_examples(inference, io, card, started)
    finally:  # no example outlives a failure here
        for proc, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    stamps["dryrun_and_examples_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_proof(card, tmp)
    stamps["proof_s"] = time.perf_counter() - t0
    print(f"entry-points phase {time.perf_counter() - t_phase:.3f} s "
          f"({ {k: round(v, 1) for k, v in stamps.items()} }) [{card}]")
    return dryrun, examples



def main(argv):
    """Run every phase; returns the exit code."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--sharded-rank"]:
        return sharded_rank(argv[1])
    if argv[:1] == ["--dp-rank"]:
        return dp_rank(argv[1])
    # the port first: outside a checkout this fails before any output
    from aind_exaspim_neuron_segmentation_tpu_torch import (
        cuda_build,
        inference,
        io,
        native,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.core.affinities import (
        affinity_channels,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
        data_handling,
        train,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.ops import (
        augment_device,
        scatter,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.ops.predigest import (
        predigest_slab,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cuda_build.load()
    print(f"K1 built and loaded in {time.perf_counter() - t0:.1f} s")

    k1 = phase_k1(scatter, dev, card)
    phase_parity(inference, dev)
    where = f"{card}; {os.cpu_count()} CPUs"
    with tempfile.TemporaryDirectory() as tmp:
        runner, vol, launches, aff, pair, t_predict, ckpt = phase_main(
            inference, predigest_slab, scatter, card, dev, tmp)
        t_build = phase_tail_build(card)
        tubes, tubes_zip = phase_tail_known(
            inference, predigest_slab, affinity_channels, card, dev, tmp)
        seg_main, crop, seg_crop = phase_tail_main(
            inference, predigest_slab, aff, pair, t_predict, card, dev, tmp)
        phase_io_build(native, t_build, where)
        lazy_launches = phase_lazy_main(inference, io, scatter, runner, vol,
                                        pair, seg_main, where, tmp)
        phase_lazy_float(inference, io, crop, seg_crop, where, tmp)
        phase_lazy_teasar(inference, io, tubes, tubes_zip, where, tmp)
        phase_cli(inference, io, runner, vol, ckpt, where, tmp)
        phase_train_parity(train, dev, card, tmp)
        phase_augment_parity(augment_device, dev, card)
        train_launches, trainer, train_ds = phase_train_full(
            train, data_handling, inference, io, scatter, card, dev, tmp)
        if "--profile" in argv:
            profile_train(trainer, data_handling, train_ds)
        sharded_launches = phase_sharded(
            inference, io, scatter, runner, vol, aff, seg_main, tubes_zip,
            ckpt, card, dev, tmp)
        t_phase = time.perf_counter()
        phase_valid_decoder(inference, runner, vol, ckpt, card, dev)
        print(f"valid-region phase {time.perf_counter() - t_phase:.3f} s "
              f"[{card}]")
        scatter.scatter_batch.launches = 0
        phase_data_parallel(train, data_handling, train_ds, card, dev, tmp)
        dp_launches = scatter.scatter_batch.launches
        torch.cuda.empty_cache()
        dryrun_launches, example_launches = phase_entry_points(
            inference, io, card, dev, tmp)
    if "--profile" in argv:
        profile_predict(inference, runner, vol)

    kernels = [dict(
        name="scatter_blend", route="cuda", source=K1_SOURCE,
        replaces=K1_REPLACES, launches=launches,
        max_abs_err=k1["max_abs_err"], ms=k1["ms"], kernel_ms=k1["ms"],
        plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
        bound_by=k1["bound_by"], library_ms=k1["library_ms"],
    )]
    print(f"K1 launches: {launches} on the main path (phase 4), "
          f"{lazy_launches} on the lazy main path (phase 9), "
          f"{train_launches} in training (phase 13: no hand kernel there), "
          f"{sharded_launches} on the sharded path at world size 1 (phase "
          f"14 (a); each rank's own count in (b)), {dp_launches} in "
          f"data-parallel training (phase 15 (b)), {dryrun_launches} on "
          f"the ranks of dryrun_multichip(8) (phase 16 (b)), "
          f"{example_launches} in the examples (phase 16 (c))")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
