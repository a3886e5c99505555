#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the repository root with one CUDA device::

    python3 chip_smoke.py            # build, check, drive, report
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown

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
8. one ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

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
K1_SOURCE = "aind_exaspim_neuron_segmentation_tpu_torch/csrc/scatter_blend.cu"
K1_REPLACES = (
    "aind_exaspim_neuron_segmentation_tpu/ops/experimental/"
    "pallas_stitch.py:95"
)


def check(cond, msg):
    """Raise unless ``cond`` holds."""
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


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


def phase_parity(inference, dev):
    """f32 forward and small predict on the card vs the port's CPU path."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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


def phase_main(inference, predigest_slab, scatter, card, dev, tmp):
    """The main path at full width, then its float32 reference; returns
    the runner, the volume, the K1 launch count of the main path, its
    affinities and digest pair and the digest predict's wall seconds."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    return runner, vol, launches, aff, (plan, qaff), t_dig


def profile_predict(inference, runner, vol):
    """Device-time breakdown of one predict by kernel (torch.profiler),
    and the host time of its CPU-side ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inference.predict(vol, runner, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    print(f"profile: wall {wall * 1e3:.1f} ms, device kernels "
          f"{total / 1e3:.1f} ms (busy share {total / 1e6 / wall:.3f}) "
          f"[one stream: kernels do not overlap]")
    # the 20 largest, and K1 wherever it ranks
    for us, count, key in [r for i, r in enumerate(rows)
                           if i < 20 or "scatter_blend" in r[2]]:
        print(f"  {us / 1e3:10.3f} ms {100 * us / total:5.1f}% "
              f"x{count:<5d} {key[:100]}")

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
    check(build.loaded_path() == path, "engine loaded from another path")
    print(f"tail build: engine built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({os.path.basename(path)}) "
          f"[{card}; {os.cpu_count()} CPUs]")


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


def main(argv):
    """Run every phase; returns the exit code."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    # the port first: outside a checkout this fails before any output
    from aind_exaspim_neuron_segmentation_tpu_torch import (
        cuda_build,
        inference,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.core.affinities import (
        affinity_channels,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.ops import scatter
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
    with tempfile.TemporaryDirectory() as tmp:
        runner, vol, launches, aff, pair, t_predict = phase_main(
            inference, predigest_slab, scatter, card, dev, tmp)
        phase_tail_build(card)
        phase_tail_known(inference, predigest_slab, affinity_channels, card,
                         dev, tmp)
        phase_tail_main(inference, predigest_slab, aff, pair, t_predict,
                        card, dev, tmp)
    if "--profile" in argv:
        profile_predict(inference, runner, vol)

    kernels = [dict(
        name="scatter_blend", route="cuda", source=K1_SOURCE,
        replaces=K1_REPLACES, launches=launches,
        max_abs_err=k1["max_abs_err"], ms=k1["ms"], kernel_ms=k1["ms"],
        plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
        bound_by=k1["bound_by"], library_ms=k1["library_ms"],
    )]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
