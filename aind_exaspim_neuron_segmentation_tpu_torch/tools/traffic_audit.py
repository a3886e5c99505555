"""Device-memory traffic audit of the UNet3D bf16 forward.

Puts the forward's device time into bytes against a minimum:

1. runs the production forward -- ``ops.stitch.forward_batch`` of the
   full-width bf16 model with folded BatchNorm (``load_model``'s default
   on a card) over B patches of 96^3 gathered from a slab, with
   ``valid_trim=--trim`` -- under ``torch.profiler`` (``record_shapes``,
   ``profile_memory``), data-chained over ``--iters`` iterations;
2. per aten op that launched device kernels, its device time is the sum
   of its kernels (``FunctionEvent.kernels``) and its bytes are reckoned
   from its input shapes and dtypes and its output: an in-place op
   (``add_``, ``copy_``, ...) writes its first input, any other op writes
   what it allocated (``device_memory_usage``: its outputs, workspaces
   being freed inside it); kernels with no aten parent are listed by
   kernel name, with their time and no bytes;
3. prints a per-op table (bytes, time, effective GB/s against the card's
   3.35e12 B/s), sums the bytes per iteration and compares the sum with
   a hand-computed minimal-traffic model (each activation written once
   and read once, weights read once): measured/minimal <= 1.3x means
   the forward moves no more than the minimum by much and its time is
   the kernels' rate; above, the top rows localize the extra passes.

Usage::

    python -m aind_exaspim_neuron_segmentation_tpu_torch.tools.traffic_audit \
        [--batch 16] [--iters 4] [--trim 0|8] [--top 25] [--out FILE.md]

Run on the card; ``--device cpu`` runs the same reckoning over the host
profile (rows are then the innermost ops with traffic, timed on the host),
whose numbers say nothing of a card.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch.core.device import (
    resolve_device,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops.upsample import (
    x2_support_trim,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data-sheet memory rate
DTYPE_BYTES = {
    "double": 8, "float": 4, "c10::Half": 2, "c10::BFloat16": 2,
    "long int": 8, "long": 8, "int": 4, "short int": 2, "short": 2,
    "signed char": 1, "unsigned char": 1, "bool": 1,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
}
# in-place ops that overwrite their first input without reading it
WRITE_ONLY = {"aten::copy_": 1, "aten::fill_": 0, "aten::zero_": 0}
# ops that only make, view or pass on tensors (a copy they make runs in a
# child op): never a row on the host
METADATA = {
    "aten::to", "aten::contiguous", "aten::narrow", "aten::squeeze",
    "aten::flatten", "aten::unflatten", "aten::split", "aten::chunk",
    "aten::movedim", "aten::expand_as", "aten::view_as", "aten::type_as",
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::resize_", "aten::as_strided", "aten::as_strided_", "aten::view",
    "aten::reshape", "aten::_reshape_alias", "aten::detach",
    "aten::alias", "aten::slice", "aten::select", "aten::unsqueeze",
    "aten::expand", "aten::permute", "aten::transpose", "aten::t",
    "aten::lift_fresh", "aten::_unsafe_view", "aten::set_",
}
ANNOTATION = "traffic_audit_forward"


def tensor_bytes(shapes, dtypes):
    """Bytes of each tensor input: ``shapes`` and ``dtypes`` as the
    profiler records them (non-tensor inputs and tensor lists give 0)."""
    out = []
    for shape, dtype in zip(shapes, dtypes):
        size = DTYPE_BYTES.get(dtype)
        out.append(0 if size is None or not isinstance(shape, list)
                   or not shape else int(np.prod(shape)) * size)
    return out


def op_traffic(name, shapes, dtypes, allocated):
    """(bytes read, bytes written) of one op from its input ``shapes``
    and ``dtypes`` and the bytes it ``allocated`` (inclusive of its
    children)."""
    sizes = tensor_bytes(shapes, dtypes)
    if name.endswith("_") and sizes:
        reads = (sizes[1:WRITE_ONLY[name] + 1] if name in WRITE_ONLY
                 else sizes)
        return sum(reads), sizes[0]
    written = max(int(allocated), 0)
    read = sum(sizes)
    if "TensorList" in dtypes:  # cat and kin: reads what it writes
        read += written
    return read, written


def _dtypes_of(prof):
    """``event -> input dtypes``: the FunctionEvent's own, or, where it
    keeps none, those of the host-side kineto event of the same id and
    name (device activities number their ids apart from host ops, so the
    id alone can name another event)."""
    from torch.autograd import DeviceType

    kineto = None

    def get(evt):
        nonlocal kineto
        got = getattr(evt, "input_dtypes", None)
        if got:
            return list(got)
        if kineto is None:
            kineto = {(e.correlation_id(), e.name()): list(e.dtypes())
                      for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CPU}
        return kineto.get((evt.id, evt.name), [])

    return get


def _descendants(evt):
    stack = list(evt.cpu_children)
    while stack:
        e = stack.pop()
        yield e
        stack.extend(e.cpu_children)


def _kernel_us(evt):
    return sum(k.duration for k in evt.kernels)


def audit_rows(prof, device_type, iters):
    """Per-op rows of a profile whose forward iterations ran under
    ``record_function(ANNOTATION)``: ``(name, shapes, bytes read, bytes
    written, ms per iteration, calls per iteration)``; the kernels those
    ops launched and the unparented kernels, each as ``(kernel name, ms
    per iteration, calls per iteration)``.

    On a card a row is an op that launched kernels; on the host, an op
    with traffic none of whose descendants has any (metadata ops aside).
    """
    from torch.autograd import DeviceType

    dtypes_of = _dtypes_of(prof)
    events = list(prof.events())
    roots = [e for e in events if e.name == ANNOTATION]
    on_card = device_type == "cuda"
    agg, launched_by = {}, {}

    def traffic(e):
        mem = e.device_memory_usage if on_card else e.cpu_memory_usage
        return op_traffic(e.name, e.input_shapes or [], dtypes_of(e), mem)

    for root in roots:
        ops = [e for e in _descendants(root)
               if e.device_type == DeviceType.CPU]
        if on_card:
            picked = [(e, _kernel_us(e)) for e in ops if e.kernels]
        else:
            work = {id(e) for e in ops
                    if e.name not in METADATA and sum(traffic(e)) > 0}
            picked = [(e, e.self_cpu_time_total) for e in ops
                      if id(e) in work
                      and not any(id(d) in work for d in _descendants(e))]
        for e, us in picked:
            for k in e.kernels:
                ent = launched_by.setdefault(k.name, [0.0, 0])
                ent[0] += k.duration
                ent[1] += 1
            read, written = traffic(e)
            # a tensor list records no shapes: its bytes tell cats apart
            key = (e.name, str(e.input_shapes), read, written)
            row = agg.setdefault(key, [e.name, key[1], read, written, 0.0,
                                       0])
            row[4] += us
            row[5] += 1
    rows = [(n, s, r, w, us / 1e3 / iters, c / iters)
            for n, s, r, w, us, c in agg.values()]
    rows.sort(key=lambda r: -r[4])
    kernels = _per_iteration(launched_by, iters)

    orphans = []
    if on_card:
        from collections import Counter

        launched = Counter()
        for e in events:
            for k in e.kernels:
                launched[(k.name, round(k.duration, 3))] += 1
        left = {}
        for e in events:
            if (e.device_type != DeviceType.CUDA or e.name == ANNOTATION
                    or getattr(e, "is_user_annotation", False)):
                continue
            us = e.time_range.end - e.time_range.start
            key = (e.name, round(us, 3))
            if launched[key]:
                launched[key] -= 1
                continue
            ent = left.setdefault(e.name, [0.0, 0])
            ent[0] += us
            ent[1] += 1
        orphans = _per_iteration(left, iters)
    return rows, kernels, orphans


def _per_iteration(totals, iters):
    """``{name: [us, calls]}`` as ``(name, ms/iter, calls/iter)`` rows,
    largest first."""
    return sorted(((n, us / 1e3 / iters, c / iters)
                   for n, (us, c) in totals.items()), key=lambda r: -r[1])


def build_forward(batch=16, trim=0, device=None):
    """(forward of one slab, the slab, the module): ``batch`` patches of
    96^3 at x-starts ``64 k`` of a seeded (96, 96, 64 (batch - 1) + 96)
    slab through ``forward_batch`` of ``load_model``'s runner."""
    from aind_exaspim_neuron_segmentation_tpu_torch import inference
    from aind_exaspim_neuron_segmentation_tpu_torch.ops.stitch import (
        forward_batch,
    )

    dev = resolve_device(device)
    runner = inference.load_model(affinity_mode=True, device=dev)
    slab = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (96, 96, 64 * (batch - 1) + 96)).astype(np.float32)).to(dev)
    starts = torch.tensor([(0, 0, 64 * k) for k in range(batch)],
                          dtype=torch.int32, device=dev)
    valid = torch.ones(batch, device=dev)

    def fwd(volume):
        return forward_batch(runner.module, volume, starts, valid,
                             patch_shape=(96, 96, 96), trim=trim)

    return fwd, slab, runner.module


def capture(fwd, slab, iters, device_type):
    """Profile ``iters`` data-chained forwards (each under the
    annotation); returns the profiler and the wall seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        if device_type == "cuda":
            torch.cuda.synchronize()

    activities = [ProfilerActivity.CPU]
    if device_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.inference_mode():
        fwd(slab)  # warm: cuDNN's algorithm choice stays out of the trace
        sync()
        with profile(activities=activities, record_shapes=True,
                     profile_memory=True) as prof:
            t0 = time.perf_counter()
            x = slab
            for _ in range(iters):
                with record_function(ANNOTATION):
                    y = fwd(x)
                # data-chain so no iteration starts before the last ends
                x = slab + y.reshape(-1)[0] * 0
            sync()
            wall = time.perf_counter() - t0
    return prof, wall


def minimal_traffic_model(batch=16, trim=0, params=12_940_224):
    """Hand-computed minimum device-memory bytes per forward iteration.

    Model: every activation tensor is written once by its producer and
    read once by its consumer(s) (skip connections read twice), weights
    read once, input read once, output written once. bf16 activations
    and weights; the final sigmoid output is f32 (3 channels). The
    layout (NCDHW here) does not change any of it.

    Channel ladder is the trilinear UNet3D at width 1 (``factor = 2``):
    encoder (32, 64, 128, 256) with a halved 256-channel bottleneck,
    decoder DoubleConv mid = the skip width and out = half the level
    width (except the last, 32). ``params`` is the weight count read per
    iteration (the audit passes the built module's).

    ``trim=t > 0`` models the valid-region-decoded forward
    (``UNet3D.forward(valid_trim=t)``): the final decoder stage computes
    only the kept core (the upsample emits ``96 - 2(t-2)`` rows per axis,
    the two unpadded convs take ``2`` each), the enc0 skip is read only
    over that support, and the cascaded up3 stage (trim ``s`` from
    :func:`..ops.upsample.x2_support_trim`) shrinks the same way. The
    encoder is unchanged (the full receptive field is still required).
    """
    chans = [32, 64, 128, 256, 256]  # trilinear: bottleneck halved
    # decoder (trilinear): x1 entering each upsample, DoubleConv mid
    # (= (up + skip) / 2) and out (= level width halved; last is 32)
    up_src = {3: 256, 2: 128, 1: 64, 0: 32}
    dec_mid = {3: 256, 2: 128, 1: 64, 0: 32}
    dec_out = {3: 128, 2: 64, 1: 32, 0: 32}
    res = [96, 48, 24, 12, 6]
    act = 2  # bf16
    B = batch
    total = 0
    entries = []

    def add(name, nbytes):
        nonlocal total
        entries.append((name, nbytes))
        total += int(nbytes)

    t = int(trim)
    s = 0
    if t >= 2:
        a = res[1]  # half-res rows feeding the final upsample
        s = x2_support_trim(a, t - 2, 2 * a - (t - 2))
        if s < 2 or a - 2 * s <= 0:
            s = 0

    # per-level decoder output dims (full forward unless trimmed)
    dec_dim = {lvl: res[lvl] for lvl in range(4)}
    up_dim = {lvl: res[lvl] for lvl in range(4)}
    skip_dim = {lvl: res[lvl] for lvl in range(4)}
    if t >= 2:
        up_dim[0] = res[0] - 2 * (t - 2)   # rows the sliced upsample emits
        skip_dim[0] = res[0] - 2 * (t - 2)
        dec_dim[0] = res[0] - 2 * t        # after the two VALID convs
        if s:
            up_dim[1] = res[1] - 2 * (s - 2)
            skip_dim[1] = res[1] - 2 * (s - 2)
            dec_dim[1] = res[1] - 2 * s

    # input volume (f32 read once)
    add("input f32", B * 96**3 * 1 * 4)
    # Encoder: each DoubleConv writes 2 activations at its resolution;
    # each is read by the next conv; skip tensors are read again by the
    # decoder concat. Downsample (maxpool) reads/writes once.
    for lvl in range(5):
        r, c = res[lvl], chans[lvl]
        n = B * r**3 * c * act
        add(f"enc{lvl} conv1 out ({r}^3 x{c})", 2 * n)  # write + read
        add(f"enc{lvl} conv2 out ({r}^3 x{c})", 2 * n)
        if lvl < 4:
            add(f"enc{lvl} skip reread",
                B * skip_dim[lvl]**3 * c * act)  # decoder concat read
            add(f"pool{lvl} out", 2 * (B * res[lvl + 1]**3 * c * act))
    # Decoder: 4 up levels; upsample writes at the higher res with the
    # lower level's channels, concat feeds DoubleConv (c_out = chans).
    # conv1 output sits between the upsample dim and the final dim.
    for lvl in range(3, -1, -1):
        r = res[lvl]
        c_up = up_src[lvl]
        u, d = up_dim[lvl], dec_dim[lvl]
        mid = d + 2 if d != r else r  # VALID conv1 out when trimmed
        add(f"up{lvl} upsampled ({u}^3 x{c_up})",
            2 * (B * u**3 * c_up * act))
        add(f"dec{lvl} conv1 out ({mid}^3 x{dec_mid[lvl]})",
            2 * (B * mid**3 * dec_mid[lvl] * act))
        add(f"dec{lvl} conv2 out ({d}^3 x{dec_out[lvl]})",
            2 * (B * d**3 * dec_out[lvl] * act))
    # output (f32, 3 channels, written once)
    out_dim = dec_dim[0]
    add(f"output f32 x3 ({out_dim}^3)", B * out_dim**3 * 3 * 4)
    # weights, read once (bf16)
    add(f"weights bf16 ({params / 1e6:.2f}M params)", params * act)
    return total, entries


def report(rows, kernels, orphans, minimal, model_entries, args, wall):
    """The audit as markdown lines; returns them and the figures."""
    total_bytes = sum((r + w) * calls for _, _, r, w, _, calls in rows)
    op_ms = sum(r[4] for r in rows)
    orphan_ms = sum(o[1] for o in orphans)
    ratio = total_bytes / minimal if minimal else float("inf")
    lines = [f"# Device-memory traffic audit (B={args.batch} bf16 forward, "
             f"trim {args.trim}, {args.iters} chained iters, wall "
             f"{wall:.3f} s, {args.device})\n",
             "| op | input shapes | MB in | MB out | calls/iter | ms/iter "
             "| eff GB/s | of 3.35 TB/s |",
             "|---|---|---|---|---|---|---|---|"]
    for name, shapes, r, w, ms, calls in rows[:args.top]:
        gbs = (r + w) * calls / (ms / 1e3) / 1e9 if ms > 0 else 0.0
        lines.append(
            f"| {name} | {shapes[:60]} | {r / 1e6:.1f} | {w / 1e6:.1f} | "
            f"{calls:g} | {ms:.3f} | {gbs:.1f} | "
            f"{gbs * 1e9 / HBM_BYTES_PER_S:.1%} |")
    by_op = {}
    for name, _, r, w, ms, calls in rows:
        ent = by_op.setdefault(name, [0.0, 0.0])
        ent[0] += ms
        ent[1] += (r + w) * calls
    lines += ["", "By op: | op | ms/iter | GB/iter |", "|---|---|---|"]
    lines += [f"| {n} | {ms:.3f} | {b / 1e9:.3f} |" for n, (ms, b) in
              sorted(by_op.items(), key=lambda kv: -kv[1][0])]
    for title, table in (("Kernels the ops launched", kernels),
                         ("Kernels with no aten parent", orphans)):
        if table:
            lines += ["", f"{title}:", "", "| kernel | calls/iter | ms/iter |",
                      "|---|---|---|"]
            lines += [f"| {n[:90]} | {c:g} | {ms:.3f} |"
                      for n, ms, c in table[:args.top]]
    lines += ["",
              f"- ops: {len(rows)}; op time on {args.device} {op_ms:.3f} "
              f"ms/iter; "
              f"kernels with no aten parent {orphan_ms:.3f} ms/iter",
              f"- measured bytes/iter (sum of op inputs + outputs): "
              f"{total_bytes / 1e9:.3f} GB",
              f"- minimal-traffic model: {minimal / 1e9:.3f} GB (each "
              "activation written once + read once, skips reread, "
              "weights once)",
              f"- measured / minimal = {ratio:.3f}x ("
              + ("<= 1.3x: near the minimum" if ratio <= 1.3 else
                 "> 1.3x: the top rows hold the extra passes") + ")",
              f"- bandwidth floor of the minimum "
              f"{minimal / HBM_BYTES_PER_S * 1e3:.3f} ms/iter at 3.35 TB/s",
              "", "Model detail:"]
    lines += [f"  - {name}: {nbytes / 1e6:.1f} MB"
              for name, nbytes in model_entries]
    fig = dict(batch=args.batch, trim=args.trim, iters=args.iters,
               measured_gb=total_bytes / 1e9, minimal_gb=minimal / 1e9,
               ratio=ratio, op_ms=op_ms, orphan_ms=orphan_ms,
               top=[(n, ms) for n, _, _, _, ms, _ in rows[:5]])
    return lines, fig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=None)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument(
        "--trim", type=int, default=0,
        help="valid_trim of the forward (the minimal-traffic model follows "
             "the trimmed dataflow)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    args.device = dev.type

    print("# building the forward...", file=sys.stderr)
    fwd, slab, module = build_forward(args.batch, args.trim, dev)
    print("# capturing the profile...", file=sys.stderr)
    prof, wall = capture(fwd, slab, args.iters, dev.type)
    rows, kernels, orphans = audit_rows(prof, dev.type, args.iters)
    params = sum(p.numel() for p in module.parameters())
    minimal, entries = minimal_traffic_model(args.batch, args.trim, params)
    lines, fig = report(rows, kernels, orphans, minimal, entries, args,
                        wall)
    text = "\n".join(lines)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(json.dumps(fig))
    return fig


if __name__ == "__main__":
    main()
