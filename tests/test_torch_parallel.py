"""The port's multi-rank inference against the JAX package's, on the CPU.

Order statistics: ``order_stat`` and the sharded order statistics equal
``np.sort`` / ``np.percentile`` bit for bit (above 2**24 elements too),
``percentile_device`` and ``rank_plan`` equal the JAX package's.

``predict_sharded``: the JAX side runs on the 8-device virtual CPU mesh
of ``tests/conftest.py``; the port runs in one job of 8 gloo ranks
(``tests/torch_ranks.py``, started once for the whole file) whose meshes
mirror ``tests/test_parallel.py``. Each rank returns its own fill
(``allow_partial``) or the shared store; the fills are disjoint, so
their sum is the volume. Rules: max-abs <= 1e-6 from the port's own
single-device ``predict`` (the strip merge reorders float32 additions);
MAE <= 1e-5 from the JAX ``predict_sharded`` on the same mesh shape;
digests bit for bit against the digest of the same run's floats. Each
comparison prints a ``{"parity": ...}`` line (``pytest -s``).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aind_exaspim_neuron_segmentation_tpu import inference as jinf
from aind_exaspim_neuron_segmentation_tpu import parallel as jpar
from aind_exaspim_neuron_segmentation_tpu.core.normalize import (
    normalize_jax,
    preprocess_jax,
)
from aind_exaspim_neuron_segmentation_tpu.ops import predigest as jpredigest
from aind_exaspim_neuron_segmentation_tpu.parallel import (
    sharded_inference as jsharded,
)
from aind_exaspim_neuron_segmentation_tpu.parallel import stats as jstats
from aind_exaspim_neuron_segmentation_tpu_torch import inference, parallel
from aind_exaspim_neuron_segmentation_tpu_torch.core import (
    normalize_device,
    preprocess_device,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import write_zarr
from aind_exaspim_neuron_segmentation_tpu_torch.ops import predigest
from aind_exaspim_neuron_segmentation_tpu_torch.parallel import (
    sharded_inference,
    stats,
)
from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import (
    StageTimer,
)
from tests import torch_ranks
from tests.test_torch_gpu import parity_line

torch.set_num_threads(1)

WORLD = 8
WIDTH = 0.25
BASE = dict(patch_shape=(32, 32, 32), overlap=(8, 8, 8), trim=4,
            batch_size=4)
HALO = dict(patch_shape=(32, 32, 32), overlap=(16, 8, 8), trim=2,
            batch_size=4)
DEEP = dict(patch_shape=(32, 32, 32), overlap=(22, 8, 8), trim=4,
            batch_size=4)
MESH2D = dict(patch_shape=(32, 32, 32), overlap=(16, 16, 8), trim=2,
              batch_size=4)


def _volumes():
    """Seeded inputs of tests/test_parallel.py's cases, by name."""
    def uni(seed, shape):
        rng = np.random.default_rng(seed)
        return rng.uniform(0, 2000, shape).astype(np.float32)

    def u16(seed, shape):
        rng = np.random.default_rng(seed)
        return rng.integers(0, 2000, shape).astype(np.uint16)

    return dict(
        v1=uni(1, (96, 56, 40)), halo=uni(7, (96, 48, 40)),
        deep=uni(8, (52, 40, 40)), v2d=uni(11, (96, 88, 40)),
        par=u16(21, (96, 56, 40)), dig=u16(61, (64, 48, 32)),
        band=u16(33, (96, 56, 40)), single=u16(40, (64, 40, 32)),
        fg=u16(50, (64, 40, 32)),
    )


# name -> (volume, mesh shape, predict kwargs, input kind, model)
CASES = {
    "mesh4": ("v1", (4,), BASE, "npy", "aff"),
    "more_ranks_than_rows": ("v1", (8,), BASE, "npy", "aff"),
    "one_rank_mesh": ("v1", (1,), BASE, "npy", "aff"),
    "spill_positive": ("halo", (4,), HALO, "npy", "aff"),
    "spill_exceeds_own": ("deep", (8,), DEEP, "npy", "aff"),
    "mesh2x2": ("v2d", (2, 2), MESH2D, "npy", "aff"),
    "mesh4x2": ("v2d", (4, 2), MESH2D, "npy", "aff"),
    "mesh2x4": ("v2d", (2, 4), MESH2D, "npy", "aff"),
    "lazy_zarr_out": ("par", (8,), dict(BASE, out_path="out.zarr"), "zarr",
                      "aff"),
    "lazy_2d": ("par", (2, 2), BASE, "zarr", "aff"),
    "gaussian": ("par", (4,), dict(BASE, blend_mode="gaussian"), "npy",
                 "aff"),
    "band1": ("band", (2,), dict(BASE, max_band_rows=1), "npy", "aff"),
    "band2": ("band", (2,), dict(BASE, max_band_rows=2), "npy", "aff"),
    "band_2d_zarr_out": ("band", (2, 2),
                         dict(BASE, max_band_rows=2, out_path="b.zarr"),
                         "zarr", "aff"),
    "forced_single_band": ("single", (2,), dict(BASE, max_band_rows=0),
                           "npy", "aff"),
    "foreground": ("fg", (4,), dict(BASE, affinity_mode=False), "npy",
                   "fg"),
    "digest_mesh4": ("dig", (4,), BASE, "npy", "aff"),
    "digest_mesh2x2": ("dig", (2, 2), BASE, "npy", "aff"),
    "digest_mesh2x4": ("dig", (2, 4), BASE, "npy", "aff"),
    "digest_uncovered_tail": ("v1", (2, 2), BASE, "npy", "aff"),
}
DIGEST_CASES = [n for n in CASES if n.startswith("digest_")]
STATS_MESHES = [(2,), (4,)]
STATS_KS = [0, 1, 37, 4095, 4096, 9000]
STATS_QS = (1, 99.9, 50, 37.5)


class Job:
    """The 8-rank job of this file: its steps, its inputs and results."""

    def __init__(self, root):
        self.root = root
        self.vols = _volumes()
        # the port's seeded random weights, read by both packages
        self.ckpt = os.path.join(root, "unet.pth")
        self.runner = inference.load_model(
            None, device="cpu", width_multiplier=WIDTH)
        torch.save(self.runner.module.state_dict(), self.ckpt)
        self.jrun = jinf.load_model(self.ckpt, width_multiplier=WIDTH,
                                    dtype=jnp.float32)
        self.fg_runner = inference.load_model(
            None, affinity_mode=False, device="cpu", width_multiplier=WIDTH)
        paths = {}
        for name, vol in self.vols.items():
            paths[name, "npy"] = os.path.join(root, f"{name}.npy")
            np.save(paths[name, "npy"], vol)
            paths[name, "zarr"] = os.path.join(root, f"{name}.zarr")
            write_zarr(paths[name, "zarr"], vol, chunks=(32, 32, 32),
                       compressor={"id": "blosc", "cname": "lz4",
                                   "clevel": 5, "shuffle": 1})
        self.stats_input = os.path.join(root, "stats.npy")
        rng = np.random.default_rng(5)
        x = rng.normal(0, 300, 20011).astype(np.float32)
        x[::7] = np.round(x[::7])  # ties
        np.save(self.stats_input, x)

        steps = [("init", "init", {})]
        for shape in STATS_MESHES:
            steps.append((f"stats{shape[0]}", "stats", dict(
                mesh=list(shape), input=self.stats_input, ks=STATS_KS,
                qs=STATS_QS)))
        for name, (vol, shape, kw, kind, model) in CASES.items():
            kw = dict(kw)
            if "out_path" in kw:
                kw["out_path"] = os.path.join(root, kw["out_path"])
            else:
                kw["allow_partial"] = True
            if name in DIGEST_CASES:
                steps.append((name + "_floats", "predict", dict(
                    mesh=list(shape), input=paths[vol, kind], kw=kw,
                    ckpt=self.ckpt)))
                kw = dict(kw, predigest=True)
            steps.append((name, "predict", dict(
                mesh=list(shape), input=paths[vol, kind], kw=kw,
                ckpt=self.ckpt if model == "aff" else None,
                affinity_mode=model == "aff")))
        pair = (os.path.join(root, "plan.zarr"), os.path.join(root, "q.zarr"))
        steps.append(("digest_stores", "predict", dict(
            mesh=[4], input=paths["dig", "npy"], ckpt=self.ckpt,
            kw=dict(BASE, predigest=True, out_path=pair))))
        steps.append(("refused", "predict", dict(
            mesh=[2], input=paths["single", "npy"], ckpt=self.ckpt,
            kw=BASE)))
        self.procs = torch_ranks.launch(root, steps, WORLD)
        self.done = False

    def results(self, name):
        """Every rank's result of step ``name`` (waits for the job)."""
        if not self.done:
            torch_ranks.wait(self.procs, self.root, timeout=240)
            self.done = True
        return [torch_ranks.result(self.root, name, r) for r in range(WORLD)]

    def assembled(self, name):
        """The step's output arrays: the origin rank's store read-back, or
        the sum of the ranks' disjoint fills."""
        parts = [r for r in self.results(name) if r is not None]
        for r in parts:
            assert "error" not in r, r["error"]
        whole = [r["arrays"] for r in parts if r["arrays"] is not None]
        if len(whole) == 1 or not isinstance(parts[0]["arrays"], tuple):
            return whole[0]
        if any(r["arrays"] is None for r in parts):
            return whole[0]
        return tuple(sum(arrs) for arrs in zip(*whole))

    def reference(self, name):
        """The port's single-device ``predict`` of the case's volume."""
        vol, _, kw, _, model = CASES[name]
        kw = {k: v for k, v in kw.items()
              if k not in ("out_path", "max_band_rows")}
        runner = self.runner if model == "aff" else self.fg_runner
        with torch_ranks.one_thread():
            return inference.predict(self.vols[vol], runner,
                                     verbose=False, **kw)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    j = Job(str(tmp_path_factory.mktemp("ranks")))
    yield j
    if not j.done:
        for p in j.procs:
            p.kill()
            p.wait()


# --- against the JAX predict_sharded (first, while the ranks run) ----------


@pytest.mark.parametrize("name", ["mesh4", "mesh2x4"])
def test_predict_sharded_within_mae_of_jax(job, name):
    vol, shape, kw, _, _ = CASES[name]
    mesh = (jpar.make_mesh(shape[0]) if len(shape) == 1
            else jpar.make_mesh_2d(shape))
    want = jpar.predict_sharded(job.vols[vol], job.jrun, mesh=mesh, **kw)
    got = job.assembled(name)[0]
    fig = parity_line(f"predict_sharded {name} vs JAX", got, want)
    assert got.shape == want.shape
    assert fig["mae"] <= 1e-5, fig


# --- order statistics -----------------------------------------------------


def _stats_input(kind, n=5003):
    rng = np.random.default_rng(3)
    if kind == "uniform":
        return rng.uniform(-100, 5000, n).astype(np.float32)
    if kind == "uint16_ties":
        return rng.integers(0, 300, n).astype(np.float32)
    return (rng.standard_normal(n)
            * 10.0 ** rng.integers(-6, 7, n)).astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "uint16_ties", "wide_range"])
def test_order_stats_equal_numpy_and_jax(kind):
    x = _stats_input(kind)
    t = torch.from_numpy(x)
    srt = np.sort(x)
    for k in (0, 1, 17, x.size // 2, x.size - 2, x.size - 1):
        got = stats.order_stat(t, k)
        assert got.dtype == torch.float32
        assert got.item() == srt[k]
    for k in (0, x.size // 2, x.size - 1):  # eager JAX: a few ranks
        want = float(jstats.order_stat(jnp.asarray(x), k))
        assert stats.order_stat(t, k).item() == want
    qs = (1, 99.9, 50, 37.5, 0, 100)
    got = stats.percentile_device(t, qs).numpy()
    want_jax = np.asarray(jstats.percentile_device(jnp.asarray(x), qs))
    np.testing.assert_array_equal(got, want_jax)
    ks, plan = stats.rank_plan(x.size, qs)
    order = stats.order_stats_sharded(t, ks, None).numpy()
    np.testing.assert_array_equal(stats.lerp_plan(order, plan),
                                  np.percentile(x, qs))
    np.testing.assert_allclose(got, np.percentile(x, qs), rtol=1e-6)
    parity_line(f"order stats {kind}", bytes_equal=True)


def test_order_stats_above_2_24_elements():
    n = (1 << 24) + 4099
    x = np.random.default_rng(9).integers(0, 1 << 20, n).astype(np.float32)
    qs = (1, 99.9, 50)
    ks, plan = stats.rank_plan(n, qs)
    order = stats.order_stats_sharded(torch.from_numpy(x), ks, None).numpy()
    part = np.partition(x, ks)
    np.testing.assert_array_equal(order, part[ks])
    np.testing.assert_array_equal(stats.lerp_plan(order, plan),
                                  np.percentile(x, qs))
    got = stats.percentile_device(torch.from_numpy(x), qs).numpy()
    np.testing.assert_allclose(got, np.percentile(x, qs), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 101, 2**31 + 7])
def test_rank_plan_equals_jax(n):
    qs = (1, 99.9, 50, 0, 100, 12.5)
    if n > np.iinfo(np.int32).max:
        ks, plan = stats.rank_plan(n, qs)  # int64 counts: no guard
        assert max(ks) > 2**31
        return
    assert stats.rank_plan(n, qs) == jstats.rank_plan(n, qs)


@pytest.mark.parametrize("shape", STATS_MESHES, ids=["2_ranks", "4_ranks"])
def test_order_stats_sharded_over_gloo_ranks(job, shape):
    x = np.load(job.stats_input)
    want = np.sort(x)[STATS_KS]
    results = [r for r in job.results(f"stats{shape[0]}") if r is not None]
    assert len(results) == shape[0]
    for r in results:
        np.testing.assert_array_equal(r["order"], want)
        single = stats.percentile_sharded(torch.from_numpy(x), STATS_QS,
                                          x.size, None).numpy()
        np.testing.assert_array_equal(r["pct"], single)


def test_device_normalize_matches_jax():
    x = np.random.default_rng(2).uniform(0, 2000, (24, 20, 16)).astype(
        np.float32)
    got = preprocess_device(torch.from_numpy(x), 1000).numpy()
    want = np.asarray(preprocess_jax(jnp.asarray(x), 1000))
    fig = parity_line("preprocess_device vs preprocess_jax", got, want)
    assert fig["max_abs"] <= 1e-6
    got = normalize_device(torch.from_numpy(x), apply_clip=False).numpy()
    want = np.asarray(normalize_jax(jnp.asarray(x), apply_clip=False))
    assert parity_line("normalize_device", got, want)["max_abs"] <= 1e-6


def test_predigest_shard_bytes_equal_jax():
    rng = np.random.default_rng(4)
    aff = rng.uniform(0, 1, (3, 10, 12, 14)).astype(np.float32)
    aff[rng.uniform(size=aff.shape) < 0.1] = 0.9999
    prev_z = rng.uniform(0, 1, (12, 14)).astype(np.float32)
    prev_y = rng.uniform(0, 1, (10, 14)).astype(np.float32)
    for z_off, y_off, dims in ((0, 0, (10, 12, 14)), (5, 7, (15, 19, 12)),
                               (3, 0, (13, 30, 14))):
        got = predigest.predigest_shard(
            torch.from_numpy(aff), torch.from_numpy(prev_z),
            torch.from_numpy(prev_y), z_off, y_off, dims)
        want = jpredigest.predigest_shard(
            jnp.asarray(aff), jnp.asarray(prev_z), jnp.asarray(prev_y),
            z_off, y_off, dims)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- predict_sharded against the port's predict ---------------------------


FLOAT_CASES = [n for n in CASES if n not in DIGEST_CASES]


@pytest.mark.parametrize("name", FLOAT_CASES)
def test_predict_sharded_matches_port_predict(job, name):
    want = job.reference(name)
    got = job.assembled(name)[0]
    assert got.shape == want.shape and got.dtype == np.float32
    fig = parity_line(f"predict_sharded {name} vs predict", got, want)
    assert fig["max_abs"] <= 1e-6, fig
    if len(CASES[name][1]) == 1:  # a 1-D mesh sums in predict's order
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", DIGEST_CASES)
def test_predigest_equals_host_digest_of_sharded_floats(job, name):
    floats = job.assembled(name + "_floats")[0]
    plan, qaff = job.assembled(name)
    want_plan, want_q = predigest.predigest(floats, device="cpu")
    np.testing.assert_array_equal(plan, want_plan)
    np.testing.assert_array_equal(qaff, want_q)
    assert parity_line(f"predict_sharded {name} floats vs predict", floats,
                       job.reference(name))["max_abs"] <= 1e-6
    seg_f = inference.affinities_to_segmentation(floats, device="cpu")
    seg_p = inference.affinities_to_segmentation((plan, qaff))
    np.testing.assert_array_equal(seg_f, seg_p)


def test_digest_stores_match_in_ram(job):
    plan, qaff = job.assembled("digest_mesh4")
    plan_s, qaff_s = job.assembled("digest_stores")
    np.testing.assert_array_equal(plan_s, plan)
    np.testing.assert_array_equal(qaff_s, qaff)


def test_multi_rank_without_out_path_refused(job):
    errors = [r["error"] for r in job.results("refused") if r is not None]
    assert len(errors) == 2 and all("allow_partial" in e for e in errors)


def test_ranks_joined_under_the_jax_env_contract(job):
    for rank, r in enumerate(job.results("init")):
        assert r == dict(again=True, world=WORLD, rank=rank,
                         backend="gloo")


# --- one process (a mesh of one rank, no process group) ------------------


@pytest.fixture(scope="module")
def one(job):
    return job.runner


def test_world_one_equals_predict_and_digest(job, one):
    vol = job.vols["v1"]
    want = inference.predict(vol, one, verbose=False, **BASE)
    timer = StageTimer()
    got = parallel.predict_sharded(vol, one, timer=timer, **BASE)
    np.testing.assert_array_equal(got, want)
    assert set(timer.as_dict()) == {"load_slabs", "normalize", "forward",
                                    "fetch_assemble"}
    plan, qaff = parallel.predict_sharded(vol, one, predigest=True, **BASE)
    want_plan, want_q = predigest.predigest(got, device="cpu")
    np.testing.assert_array_equal(plan, want_plan)
    np.testing.assert_array_equal(qaff, want_q)


def test_rejected_combinations(job, one):
    vol = job.vols["dig"]
    with pytest.raises(ValueError, match="affinity_mode"):
        parallel.predict_sharded(vol, one, predigest=True,
                                 affinity_mode=False, **BASE)
    with pytest.raises(ValueError, match="out_path"):
        parallel.predict_sharded(vol, one, predigest=True,
                                 out_path="/tmp/nope.zarr", **BASE)
    with pytest.raises(ValueError, match="single band"):
        parallel.predict_sharded(vol, one, predigest=True, max_band_rows=1,
                                 **BASE)
    with pytest.raises(ValueError, match="output channels"):
        parallel.predict_sharded(vol, one, affinity_mode=False, **BASE)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        parallel.predict_sharded(
            vol, one, mesh=parallel.RankMesh(np.zeros((1, 1, 1)),
                                             ("a", "b", "c")), **BASE)


def test_empty_grid_out_path_writes_store(one, tmp_path):
    thin = np.zeros((4, 48, 48), np.float32)
    out = str(tmp_path / "thin.zarr")
    got = parallel.predict_sharded(thin, one, out_path=out, **BASE)
    assert np.asarray(got[:]).shape == (3, 4, 48, 48)
    assert not np.asarray(got[:]).any()


def test_initialize_distributed_single_process_noop(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize_distributed(device="cpu") is False
    # one process of a torchrun job: nothing to join
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert parallel.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    mesh = parallel.make_mesh()
    assert (mesh.size, mesh.coords, mesh.group) == (1, (0,), None)
    with pytest.raises(ValueError, match="need 2 ranks"):
        parallel.make_mesh(2)


def test_band_and_chunk_planners_equal_jax():
    for args in ((10, 4, 64, 96, 4 * 4 * 256 * 256),
                 (200, 4, 64, 96, 4 * 4 * 1024 * 1024), (7, 2, 24, 32, 10)):
        assert (sharded_inference._auto_band_rows(*args)
                == jsharded._auto_band_rows(*args))
    for args in ((8, 64, (32, 256, 300)), (0, 1024, (32, 2048, 100))):
        assert (sharded_inference._ysplit_chunk_grid(*args)
                == jsharded._ysplit_chunk_grid(*args))
    with pytest.warns(RuntimeWarning, match="degenerate"):
        assert sharded_inference._ysplit_chunk_grid(
            8, 125, (16, 258, 64)) == (1, 64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sharded_inference._ysplit_chunk_grid(8, 128, (16, 258, 64))
    for dim, patch, total in ((40, 32, 70), (56, 32, 56), (52, 32, 200)):
        starts = list(range(0, dim - patch + 24, 24))
        np.testing.assert_array_equal(
            sharded_inference._axis_pad_map(dim, patch, starts, total),
            jsharded._axis_pad_map(dim, patch, starts, total))
