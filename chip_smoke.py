#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the repository root with one CUDA device::

    python3 chip_smoke.py            # build, check, drive, report
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown

Phases (any failure raises, and the script exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build kernel K1 (``csrc/scatter_blend.cu``, one ``nvcc``); hold it
   against its plain version with ``torch.equal`` on four cases, the
   main-path shape among them, and time it, the plain loop and the
   library call ``index_add_`` with CUDA events;
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
5. one ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks: HBM bytes/s and float32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
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
    """Mean device time of ``fn`` in ms, from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def k1_cases(rng):
    """(acc, probs, starts, trim) cases for K1, on the host (numpy)."""
    cases = []
    # the two cases of tests/test_pallas.py
    r0 = np.random.default_rng(0)
    cases.append((
        r0.standard_normal((3, 32, 32, 32)).astype(np.float32),
        r0.standard_normal((4, 3, 8, 8, 8)).astype(np.float32),
        np.array([[0, 0, 0], [4, 4, 4], [4, 4, 4], [20, 16, 12]], np.int32),
        2,
    ))
    cases.append((
        np.random.default_rng(1).standard_normal(
            (1, 16, 16, 16)).astype(np.float32),
        np.ones((1, 1, 4, 4, 4), np.float32),
        np.array([[2, 2, 2]], np.int32),
        0,
    ))
    # seeded overlapping + duplicated starts, non-cubic core
    core, trim, dims = (10, 12, 14), 3, (40, 44, 48)
    starts = np.stack([
        rng.integers(-trim, d - c - trim + 1, 24)
        for c, d in zip(core, dims)
    ], axis=1).astype(np.int32)
    starts[5] = starts[2]
    starts[17] = starts[2]
    cases.append((
        rng.standard_normal((3,) + dims).astype(np.float32),
        rng.standard_normal((24, 3) + core).astype(np.float32),
        starts, trim,
    ))
    cases.append(main_path_k1_case(rng))
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


def phase_k1(scatter, dev):
    """Bit-equality and timing of K1 against its plain loop; timing of the
    library call ``index_add_`` that computes the same sum."""
    rng = np.random.default_rng(7)
    max_err = 0.0
    for n, (acc, probs, starts, trim) in enumerate(k1_cases(rng)):
        acc_d = torch.from_numpy(acc).to(dev)
        probs_d = torch.from_numpy(probs).to(dev)
        starts_d = torch.from_numpy(starts).to(dev)
        want = scatter.scatter_batch_reference(acc_d.clone(), probs_d,
                                               starts, trim)
        got = scatter.scatter_batch(acc_d.clone(), probs_d, starts_d,
                                    trim=trim, host_starts=starts)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"K1 case {n} differs from the plain loop (max abs {err})")
        print(f"K1 case {n}: acc {acc.shape} probs {probs.shape} "
              f"equal to the plain loop")
    # time at the main-path shape (the last case)
    acc_d = torch.from_numpy(acc).to(dev)
    kernel_ms = cuda_ms(lambda: scatter.scatter_batch(
        acc_d, probs_d, starts_d, trim=trim, host_starts=starts))
    plain_ms = cuda_ms(lambda: scatter.scatter_batch_reference(
        acc_d, probs_d, starts, trim))
    # index_add_ sums duplicates with atomics, in no fixed order: close to
    # the loop, not bit-identical; its index is built outside the clock
    idx = k1_flat_index(acc_d, probs_d, starts, trim)
    flat = probs_d.view(-1)
    lib = torch.from_numpy(acc).to(dev)
    lib.view(-1).index_add_(0, idx, flat)
    lib_err = (lib - want).abs().max().item()
    check(lib_err <= 1e-5, f"index_add_ differs from the loop by {lib_err}")
    library_ms = cuda_ms(lambda: acc_d.view(-1).index_add_(0, idx, flat))
    bound_ms, bound_by, moved = k1_bound_ms(acc.shape, probs.shape,
                                            starts, trim)
    print(f"K1 main-path shape: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms (max abs "
          f"{lib_err:.3e} from the loop), bound {bound_ms:.4f} ms "
          f"({bound_by}, {moved / 1e6:.1f} MB)")
    return dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


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
    the K1 launch count of the main path."""
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
    return runner, vol, launches


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
    for us, count, key in rows[:20]:
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

    k1 = phase_k1(scatter, dev)
    phase_parity(inference, dev)
    with tempfile.TemporaryDirectory() as tmp:
        runner, vol, launches = phase_main(inference, predigest_slab,
                                           scatter, card, dev, tmp)
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
