"""The port's distributed postprocess against the JAX package's, on the CPU.

The cases of ``tests/test_streamseg_distributed.py`` run through the
port's virtual-rank drivers (``segment_streaming_virtual``,
``skeletonize_virtual``: every rank's algorithm in one process) and its
merge bindings: labels, serialized RAG parts, luts and zip entries equal
the JAX package's and the port's single-process output bit for bit.
Then the real transport: one job of two gloo processes
(``tests/torch_ranks.py``, the JAX package's environment contract) runs
``segment_streaming_sharded`` and ``skeletonize_sharded``, and two
processes of the CLI's ``run --distributed`` (torchrun's contract) are
held to one process. Both jobs start once for the file and run while the
virtual cases do. Each comparison prints a ``{"parity": ...}`` line
(``pytest -s``).
"""

import json
import os
import socket
import sys
import tempfile
import threading
import zipfile

import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu import inference as jinf
from aind_exaspim_neuron_segmentation_tpu import native as jnative
from aind_exaspim_neuron_segmentation_tpu.io import read as jread
from aind_exaspim_neuron_segmentation_tpu.postprocess import (
    distributed as jdist,
)
from aind_exaspim_neuron_segmentation_tpu.postprocess import skeleton as jskel
from aind_exaspim_neuron_segmentation_tpu_torch import (
    inference,
    io,
    native,
    postprocess,
)
from aind_exaspim_neuron_segmentation_tpu_torch.__main__ import main
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import write_zarr
from aind_exaspim_neuron_segmentation_tpu_torch.ops import predigest
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess import (
    distributed,
    skeleton,
)
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess.distributed import (  # noqa: E501
    _TcpComm,
    partition_z,
    segment_streaming_virtual,
    skeletonize_virtual,
)
from tests import torch_ranks
from tests.test_streamseg import _blobby_affs, _noisy_affs
from tests.test_torch_gpu import parity_line

torch.set_num_threads(1)

CLI_PATCH = ["--patch", "32", "--overlap", "16,16,16", "--trim", "4",
             "--batch-size", "4", "--width-multiplier", "0.25", "--quiet",
             "--min-size", "10"]


def _stores(tmp_path, aff, name="aff.zarr"):
    """``aff`` as a zarr store, opened by the port and by the JAX package."""
    path = str(tmp_path / name)
    write_zarr(path, aff, chunks=(3, 8) + aff.shape[2:])
    return io.read(path), jread(path)


def _same(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=what)
    parity_line(what, bytes_equal=True)


def _zip_entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _labels():
    """Two tubes, a ball at the volume face and a two-component label."""
    lab = np.zeros((30, 28, 26), np.uint32)
    lab[3:27, 4:7, 4:7] = 5
    lab[12:15, 2:26, 18:21] = 2
    zz, yy, xx = np.ogrid[:30, :28, :26]
    lab[(zz - 22) ** 2 + (yy - 20) ** 2 + (xx - 0) ** 2 <= 30] = 9
    lab[2:5, 20:25, 10:13] = 7
    lab[25:28, 20:25, 10:13] = 7
    return lab


def _cli_volume():
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 300, (48, 48, 48)).astype(np.uint16)
    zz, yy, xx = np.ogrid[-10:11, -10:11, -10:11]
    vol[14:35, 14:35, 14:35][zz**2 + yy**2 + xx**2 < 100] = 1200
    return vol


class Jobs:
    """The two real multi-process jobs of this file."""

    def __init__(self, root):
        self.root = root
        self.aff = _blobby_affs(shape=(26, 18, 18), r=4, seed=31, step=10)
        self.labels = _labels()
        paths = dict(aff=os.path.join(root, "aff.zarr"),
                     plan=os.path.join(root, "plan.zarr"),
                     qaff=os.path.join(root, "qaff.zarr"),
                     labels=os.path.join(root, "labels.zarr"))
        write_zarr(paths["aff"], self.aff, chunks=(3, 6, 18, 18))
        plan, qaff = predigest.predigest(self.aff, device="cpu")
        write_zarr(paths["plan"], plan, chunks=(6, 18, 18))
        write_zarr(paths["qaff"], qaff, chunks=(3, 6, 18, 18))
        write_zarr(paths["labels"], self.labels, chunks=(8, 28, 26))
        self.zip_path = os.path.join(root, "ranks.zip")
        steps = [
            ("init", "init", {}),
            ("seg_float", "segment", dict(input=paths["aff"], kw=dict(
                out_path=os.path.join(root, "seg_f.zarr"),
                tmp_dir=root, slab_planes=4))),
            ("seg_pair", "segment", dict(
                pair=(paths["plan"], paths["qaff"]), kw=dict(tmp_dir=root))),
            ("skel", "skeleton", dict(input=paths["labels"], kw=dict(
                zip_path=self.zip_path, slab_planes=7))),
        ]
        self.rank_dir = os.path.join(root, "ranks")
        os.makedirs(self.rank_dir)
        self.ranks = torch_ranks.launch(self.rank_dir, steps, 2)

        self.cli_dir = os.path.join(root, "cli")
        os.makedirs(self.cli_dir)
        self.volume = os.path.join(root, "vol.zarr")
        io.write_zarr(self.volume, _cli_volume(), chunks=(16, 16, 16),
                      compressor={"id": "blosc", "cname": "lz4",
                                  "shuffle": 1})
        self.cli_zip = os.path.join(self.cli_dir, "out.zip")
        self.cli_work = os.path.join(self.cli_dir, "work")
        argv = [sys.executable, "-m",
                "aind_exaspim_neuron_segmentation_tpu_torch", "--device",
                "cpu", "run", "--distributed", "--input", self.volume,
                "--workdir", self.cli_work, "--output", self.cli_zip,
                ] + CLI_PATCH
        self.cli = torch_ranks.launch(self.cli_dir, None, 2,
                                      contract="torchrun", argv=argv)

    def rank_results(self, name):
        if self.ranks is not None:
            procs, self.ranks = self.ranks, None
            torch_ranks.wait(procs, self.rank_dir, timeout=240)
        return [torch_ranks.result(self.rank_dir, name, r) for r in (0, 1)]

    def cli_logs(self):
        if self.cli is not None:
            procs, self.cli = self.cli, None
            torch_ranks.wait(procs, self.cli_dir, timeout=240)
        logs = []
        for rank in (0, 1):
            with open(os.path.join(self.cli_dir, f"log.r{rank}")) as f:
                logs.append(f.read())
        return logs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    j = Jobs(str(tmp_path_factory.mktemp("dist")))
    yield j
    for procs in (j.ranks, j.cli):
        for p in procs or ():
            p.kill()
            p.wait()


# --- validation and partition ---------------------------------------------


def test_digest_pair_shape_mismatch_fails_fast(jobs):
    plan = np.zeros((8, 8, 8), np.uint8)
    qaff = np.zeros((3, 8, 8, 4), np.uint8)  # wrong W
    with pytest.raises(ValueError, match="do not match"):
        distributed._RankWorker((plan, qaff), (0, 8))


def test_partition_equals_jax():
    for d, n in ((10, 3), (8, 8), (23, 4), (5, 1)):
        parts = partition_z(d, n)
        assert parts == jdist.partition_z(d, n)
        assert parts[0][0] == 0 and parts[-1][1] == d
        sizes = [hi - lo for lo, hi in parts]
        assert max(sizes) - min(sizes) <= 1
    for d, n in ((3, 5), (7, 7)):
        assert (distributed._partition_z_skeleton(d, n)
                == jdist._partition_z_skeleton(d, n))
    with pytest.raises(ValueError):
        partition_z(3, 4)


# --- virtual ranks: labels ------------------------------------------------


def _virtual_case(tmp_path, aff, n_ranks, **kw):
    handle, jhandle = _stores(tmp_path, aff)
    got = segment_streaming_virtual(handle, n_ranks, tmp_dir=str(tmp_path),
                                    device="cpu", **kw)
    want = jdist.segment_streaming_virtual(jhandle, n_ranks,
                                           tmp_dir=str(tmp_path), **kw)
    dense_kw = {k: v for k, v in kw.items()
                if k not in ("slab_planes", "quantile_pct")}
    dense = inference.affinities_to_segmentation(aff, device="cpu",
                                                 **dense_kw)
    return got, want, dense


@pytest.mark.parametrize("n_ranks", [1, 2, 3, 5])
def test_noisy_volume_rank_invariance(tmp_path, n_ranks):
    got, want, dense = _virtual_case(
        tmp_path, _noisy_affs(shape=(22, 18, 14), seed=11), n_ranks)
    _same(f"virtual noisy {n_ranks} ranks vs JAX", got, want)
    _same(f"virtual noisy {n_ranks} ranks vs one process", got, dense)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_blobby_multi_component(tmp_path, n_ranks):
    got, want, dense = _virtual_case(tmp_path, _blobby_affs(), n_ranks,
                                     slab_planes=6)
    assert dense.max() > 1
    _same(f"virtual blobby {n_ranks} ranks vs JAX", got, want)
    _same(f"virtual blobby {n_ranks} ranks vs one process", got, dense)


def test_u_shape_fragment_across_rank_cut(tmp_path):
    aff = np.full((3, 12, 9, 9), 0.02, np.float32)
    aff[0, 0:10, 2, 2] = 0.95
    aff[0, 0:10, 2, 6] = 0.95
    aff[2, 9, 2, 2:6] = 0.95
    got, want, dense = _virtual_case(tmp_path, aff, 3, min_segment_size=0)
    assert dense.max() == 1
    _same("virtual u-shape vs JAX", got, want)
    _same("virtual u-shape vs one process", got, dense)


@pytest.mark.parametrize("min_size", [0, 5, 100])
def test_min_size_filter(tmp_path, min_size):
    aff = _blobby_affs(shape=(30, 20, 20), r=4, seed=9, step=10)
    got, want, dense = _virtual_case(tmp_path, aff, 3,
                                     min_segment_size=min_size,
                                     slab_planes=4)
    _same(f"virtual min size {min_size} vs JAX", got, want)
    _same(f"virtual min size {min_size} vs one process", got, dense)


def test_custom_thresholds_quantile_and_lowhigh(tmp_path):
    aff = _noisy_affs(shape=(18, 14, 12), seed=13)
    kw = dict(agglomeration_thresholds=(0.3, 0.7), aff_threshold_low=0.25,
              aff_threshold_high=0.9, quantile_pct=60)
    got, want, _ = _virtual_case(tmp_path, aff, 2, **kw)
    _same("virtual thresholds, quantile 60 vs JAX", got, want)
    handle, _ = _stores(tmp_path, aff, "one.zarr")
    one = postprocess.segment_streaming(handle, device="cpu", **kw)
    _same("virtual thresholds, quantile 60 vs one process", got, one)


def test_all_background(tmp_path):
    handle, _ = _stores(tmp_path, np.full((3, 10, 8, 8), 0.01, np.float32))
    got = segment_streaming_virtual(handle, 3, tmp_dir=str(tmp_path),
                                    device="cpu")
    assert got.dtype == np.uint32 and got.max() == 0


def test_digest_pair_replay(tmp_path):
    aff = _blobby_affs(shape=(26, 18, 18), r=4, seed=31, step=10)
    plan, qaff = predigest.predigest(aff, device="cpu")
    pp, qp = str(tmp_path / "p.zarr"), str(tmp_path / "q.zarr")
    write_zarr(pp, plan, chunks=(6, 18, 18))
    write_zarr(qp, qaff, chunks=(3, 6, 18, 18))
    got = segment_streaming_virtual((io.read(pp), io.read(qp)), 3,
                                    tmp_dir=str(tmp_path))
    want = jdist.segment_streaming_virtual((jread(pp), jread(qp)), 3,
                                           tmp_dir=str(tmp_path))
    _same("virtual digest pair vs JAX", got, want)
    _same("virtual digest pair vs dense", got,
          jinf.affinities_to_segmentation(aff))


def test_zarr_output_contract(tmp_path):
    aff = _blobby_affs(shape=(24, 16, 16), r=4, seed=21, step=10)
    handle, _ = _stores(tmp_path, aff)
    out = segment_streaming_virtual(handle, 2, out_path=str(
        tmp_path / "seg.zarr"), tmp_dir=str(tmp_path), device="cpu")
    want = inference.affinities_to_segmentation(aff, device="cpu")
    assert out.shape == want.shape
    _same("virtual zarr output vs one process", out[:], want)


def test_single_plane_ranks(tmp_path):
    got, want, dense = _virtual_case(
        tmp_path, _noisy_affs(shape=(6, 10, 10), seed=5), 6)
    _same("virtual one plane per rank vs JAX", got, want)
    _same("virtual one plane per rank vs one process", got, dense)


# --- the component-partitioned merge --------------------------------------


def _parts(tmp_path, aff, n_ranks, pkg):
    handle, jhandle = _stores(tmp_path, aff, f"{pkg}.zarr")
    if pkg == "port":
        workers = [
            distributed._RankWorker(
                handle, zr, tmp_dir=tempfile.mkdtemp(dir=tmp_path),
                device="cpu")
            for zr in partition_z(aff.shape[1], n_ranks)
        ]
        hub = distributed._hub_stitch
    else:
        workers = [
            jdist._RankWorker(jhandle, zr,
                              tmp_dir=tempfile.mkdtemp(dir=tmp_path))
            for zr in jdist.partition_z(aff.shape[1], n_ranks)
        ]
        hub = jdist._hub_stitch
    exports = [w.pass1() for w in workers]
    ws_per_rank, k, frag_fg, next_ws = hub(exports)
    parts = [w.pass2(ws_per_rank[r], k, next_ws[r])
             for r, w in enumerate(workers)]
    for w in workers:
        w.close()
    return parts, k, frag_fg


def test_rag_parts_bytes_equal_jax(tmp_path):
    aff = _blobby_affs(shape=(24, 18, 18), r=4, seed=3, step=9)
    parts, k, frag_fg = _parts(tmp_path, aff, 3, "port")
    jparts, jk, jfrag_fg = _parts(tmp_path, aff, 3, "jax")
    assert k == jk and parts == jparts
    _same("hub frag_fg vs JAX", frag_fg, jfrag_fg)
    th = [0.6, 0.8, 0.9]
    lut, n = native.merge_rag_parts(parts, k, frag_fg, th,
                                    min_segment_size=5)
    jlut, jn = jnative.merge_rag_parts(jparts, jk, jfrag_fg, th,
                                       min_segment_size=5)
    assert n == jn
    _same("merge_rag_parts lut vs JAX", lut, jlut)


@pytest.mark.parametrize("n_owners", [1, 2, 3, 7])
def test_owner_count_invariance(tmp_path, n_owners):
    aff = _blobby_affs(shape=(24, 18, 18), r=4, seed=3, step=9)
    parts, k, frag_fg = _parts(tmp_path, aff, 2, "port")
    th = [0.6, 0.8, 0.9]
    want_lut, want_n = native.merge_rag_parts(parts, k, frag_fg, th,
                                              min_segment_size=5)
    routed = native.route_rag_parts(parts, k, n_owners)
    assert routed == jnative.route_rag_parts(parts, k, n_owners)
    pairs = [native.merge_rag_local(b, k, th) for b in routed]
    lut, n = native.compose_rag_lut(k, frag_fg, pairs, min_segment_size=5)
    assert n == want_n
    _same(f"routed merge over {n_owners} owners", lut, want_lut)


def test_single_giant_component_routes_whole(tmp_path):
    parts, k, frag_fg = _parts(
        tmp_path, _noisy_affs(shape=(16, 12, 12), seed=4), 2, "port")
    th = [0.6, 0.8, 0.9]
    routed = native.route_rag_parts(parts, k, 3)
    n_records = [int(np.frombuffer(b[:8], np.uint64)[0]) for b in routed]
    assert sorted(n_records)[:2] == [0, 0] and max(n_records) > 0
    pairs = [native.merge_rag_local(b, k, th) for b in routed]
    assert [len(p) for p in pairs].count(0) == 2
    want_lut, want_n = native.merge_rag_parts(parts, k, frag_fg, th)
    lut, n = native.compose_rag_lut(k, frag_fg, pairs)
    assert n == want_n
    np.testing.assert_array_equal(lut, want_lut)


def test_routing_preserves_records(tmp_path):
    parts, k, _ = _parts(
        tmp_path, _blobby_affs(shape=(30, 20, 20), r=4, seed=9, step=10),
        3, "port")
    routed = native.route_rag_parts(parts, k, 4)
    assert sum(len(b) - 8 for b in routed) == sum(len(p) - 8 for p in parts)
    total = sum(int(np.frombuffer(b[:8], np.uint64)[0]) for b in routed)
    assert total == sum(int(np.frombuffer(p[:8], np.uint64)[0])
                        for p in parts)


def test_malformed_and_fuzzed_parts_rejected(tmp_path):
    with pytest.raises(RuntimeError, match="malformed"):
        native.route_rag_parts([b"\x01" + b"\0" * 10], 5, 2)
    parts, k, _ = _parts(
        tmp_path, _blobby_affs(shape=(16, 12, 12), r=4, seed=5, step=8), 2,
        "port")
    base = bytearray(parts[0])
    th = [0.6, 0.8, 0.9]
    rng = np.random.default_rng(0)
    for case in range(200):
        buf = bytearray(base)
        kind = case % 4
        if kind == 0:
            for _ in range(int(rng.integers(1, 5))):
                buf[int(rng.integers(len(buf)))] = int(rng.integers(256))
        elif kind == 1:
            buf = buf[: int(rng.integers(len(buf)))]
        elif kind == 2:
            buf += bytes(rng.integers(0, 256, 16, dtype=np.uint8))
        else:
            buf[:8] = rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
        for fn in (lambda b: native.route_rag_parts([b, parts[1]], k, 3),
                   lambda b: native.merge_rag_local(b, k, th)):
            try:
                fn(bytes(buf))
            except (RuntimeError, ValueError):
                pass


def test_double_drop_pairs_rejected():
    pairs = np.array([[1, 2], [3, 2]], np.uint32)
    with pytest.raises(RuntimeError, match="rc=-2"):
        native.compose_rag_lut(3, np.array([0, 10, 10, 10], np.uint64),
                               [pairs])


# --- the hub transport ----------------------------------------------------


def _hub_address():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def test_tcp_hub_gather_scatter_broadcast():
    addr = _hub_address()
    results = {}

    def run(rank):
        comm = _TcpComm(rank, 3, addr)
        g = comm.gather({"rank": rank, "data": np.arange(rank + 1)})
        if rank == 0:
            assert [e["rank"] for e in g] == [0, 1, 2]
            reply = [f"to-{r}" for r in range(3)]
        else:
            assert g is None
            reply = None
        assert comm.scatter(reply) == f"to-{rank}"
        results[rank] = comm.broadcast("done" if rank == 0 else None)
        comm.close()

    threads = [threading.Thread(target=run, args=(r,)) for r in (1, 2, 0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results == {0: "done", 1: "done", 2: "done"}


def test_hub_timeout_env_fails_fast(monkeypatch):
    monkeypatch.setenv("EXA_HUB_TIMEOUT_S", "0.5")
    addr = _hub_address()
    outcome = {}
    silent_done = threading.Event()

    def silent_peer():
        comm = _TcpComm(1, 2, addr)
        silent_done.wait(10)
        comm.close()

    def hub():
        comm = _TcpComm(0, 2, addr)
        try:
            comm.gather("x")
            outcome["err"] = None
        except socket.timeout as e:
            outcome["err"] = e
        finally:
            silent_done.set()
            comm.close()

    threads = [threading.Thread(target=silent_peer),
               threading.Thread(target=hub)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert isinstance(outcome["err"], socket.timeout)


# --- skeletons and the single-process stats contract ----------------------


@pytest.mark.parametrize("n_ranks", [1, 2, 3])
def test_skeletonize_virtual_equals_jax_and_lazy(tmp_path, n_ranks):
    lab = _labels()
    path = str(tmp_path / "lab.zarr")
    write_zarr(path, lab, chunks=(8, 28, 26))
    got = skeletonize_virtual(io.read(path), n_ranks, slab_planes=7)
    want = jdist.skeletonize_virtual(jread(path), n_ranks, slab_planes=7)
    lazy = skeleton.skeletonize_lazy(io.read(path))
    assert sorted(got) == sorted(want) == sorted(lazy) == [2, 5, 7, 9]
    for lab_id in got:
        for field in ("vertices", "radii", "edges"):
            _same(f"skeletonize_virtual {n_ranks} {lab_id} {field}",
                  getattr(got[lab_id], field), getattr(want[lab_id], field))
        assert got[lab_id].to_swc() == lazy[lab_id].to_swc()


def test_single_process_stats_contract(tmp_path):
    aff = _blobby_affs(shape=(16, 12, 12), r=4, seed=5, step=8)
    stats, jstats = {}, {}
    z0, labels = postprocess.segment_streaming_sharded(
        aff, min_segment_size=10, tmp_dir=str(tmp_path), stats_out=stats,
        device="cpu")
    jz0, jlabels = jdist.segment_streaming_sharded(
        aff, min_segment_size=10, tmp_dir=str(tmp_path), stats_out=jstats)
    assert z0 == jz0 == 0
    _same("segment_streaming_sharded, one process, vs JAX", labels,
          jlabels)
    assert set(stats) == set(jstats)
    assert stats["rag_part_bytes"] == jstats["rag_part_bytes"]
    assert stats["bytes_sent"] == stats["bytes_recv"] == 0
    assert stats["ranks"] == [{k: v for k, v in stats.items()
                               if k != "ranks"}]

    lab = np.zeros((12, 12, 12), np.uint32)
    lab[2:10, 2:5, 2:10] = 1
    lab[2:10, 7:10, 2:10] = 2
    stats, jstats = {}, {}
    zp, jzp = str(tmp_path / "a.zip"), str(tmp_path / "b.zip")
    got = postprocess.skeletonize_sharded(lab, zip_path=zp, stats_out=stats)
    jdist.skeletonize_sharded(lab, zip_path=jzp, stats_out=jstats)
    assert set(got) == {1, 2} and set(stats) == set(jstats)
    assert stats["n_skeletons"] == stats["labels_local"] == 2
    assert _zip_entries(zp) == _zip_entries(jzp)


# --- two real processes ---------------------------------------------------


def test_ranks_joined(jobs):
    for rank, r in enumerate(jobs.rank_results("init")):
        assert r == dict(again=True, world=2, rank=rank, backend="gloo")


def test_segment_streaming_sharded_two_processes(jobs):
    want = jinf.affinities_to_segmentation(jobs.aff)
    assert want.max() > 1
    for name in ("seg_float", "seg_pair"):
        results = jobs.rank_results(name)
        if name == "seg_float":  # the shared store, read on every rank
            for r in results:
                _same(f"{name} store vs JAX dense", r["labels"], want)
        else:  # each rank's own rows
            got = np.concatenate([r["labels"] for r in results])
            assert [r["z0"] for r in results] == [0, want.shape[0] // 2]
            _same(f"{name} rows vs JAX dense", got, want)
        ranks = results[0]["stats"]["ranks"]
        assert [s["rank"] for s in ranks] == [0, 1]
        for s in ranks:
            assert {"pass1_s", "rag_build_s", "rag_part_bytes",
                    "routed_bytes", "merge_local_s", "merge_pairs",
                    "relabel_s", "bytes_sent", "bytes_recv"} <= set(s)
        assert {"stitch_s", "route_s", "compose_s"} <= set(ranks[0])
        assert ranks[1]["bytes_sent"] > 0 and "ranks" not in \
            results[1]["stats"]


def test_skeletonize_sharded_two_processes(jobs, tmp_path):
    results = jobs.rank_results("skel")
    local = [set(r["swc"]) for r in results]
    assert not local[0] & local[1] and local[0] | local[1] == {2, 5, 7, 9}
    path = str(tmp_path / "lab.zarr")
    write_zarr(path, jobs.labels, chunks=(8, 28, 26))
    want = str(tmp_path / "want.zip")
    jinf.skeletons_to_zipped_swcs(jskel.skeletonize_lazy(jread(path)), want)
    got = _zip_entries(jobs.zip_path)
    assert got == _zip_entries(want)
    assert results[0]["stats"]["n_skeletons"] == 4
    parity_line("skeletonize_sharded 2 processes zip vs JAX",
                entries=len(got), bytes_equal=True)


def test_cli_run_distributed_equals_one_process(jobs, tmp_path, capsys):
    logs = jobs.cli_logs()
    lines = [ln for log in logs for ln in log.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, logs  # rank 0 alone prints the result
    out = json.loads(lines[0])
    assert out["run"] == jobs.cli_zip
    assert [s["rank"] for s in out["segment_protocol"]] == [0, 1]
    assert [s["rank"] for s in out["swc_protocol"]] == [0, 1]

    work, zp = str(tmp_path / "work"), str(tmp_path / "one.zip")
    with torch_ranks.one_thread():
        main(["--device", "cpu", "run", "--input", jobs.volume,
              "--workdir", work, "--output", zp] + CLI_PATCH)
    capsys.readouterr()
    one = io.read(os.path.join(work, "segmentation.zarr"))[:]
    two = io.read(os.path.join(jobs.cli_work, "segmentation.zarr"))[:]
    _same("CLI run --distributed labels vs one process", two, one)
    assert one.max() > 0
    entries = _zip_entries(jobs.cli_zip)
    assert entries == _zip_entries(zp) and entries
    parity_line("CLI run --distributed zip vs one process",
                entries=len(entries), bytes_equal=True)
