"""Predict's streamed copy-out, on the CPU.

``inference.predict`` divides and copies out each chunk of Z planes as
soon as the batches queued so far make it final, one chunk behind the
device. The result must hold the bits of the slab-at-once composition
(``tests.test_torch_gpu.slab_at_once``: each slab's whole accumulator,
then one divide), whatever the batches' layout over the patch rows, and
``predict.copy_out_chunks`` counts the chunks streamed.
"""

import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu_torch import inference
from tests.test_torch_gpu import assert_same_bits, slab_at_once

torch.set_num_threads(1)

# (64, 48, 48) under patch 32, overlap 16: 3 patch rows at z 0, 16, 32,
# each of 2 x 2 patches; with trim 4 the rows' planes end at 20, 36, 64.
GRID = dict(patch_shape=(32,) * 3, overlap=(16,) * 3, trim=4)


@pytest.fixture(scope="module")
def vol():
    rng = np.random.default_rng(18)
    v = rng.uniform(0, 400, (64, 48, 48)).astype(np.float32)
    v[8:56, 10:38, 12:30] += 1200
    return v


@pytest.fixture(scope="module")
def runners():
    return {mode: inference.load_model(device="cpu", width_multiplier=0.25,
                                       affinity_mode=mode)
            for mode in (True, False)}


@pytest.mark.parametrize("kw, chunks", [
    pytest.param(dict(batch_size=4), 3, id="one_batch_a_row"),
    pytest.param(dict(batch_size=2), 4, id="row_spans_two_batches"),
    pytest.param(dict(batch_size=3), 4, id="batches_straddle_rows"),
    pytest.param(dict(batch_size=5), 3, id="padding_in_last_batch"),
    pytest.param(dict(batch_size=4, max_slab_rows=2), 3, id="two_slabs"),
    pytest.param(dict(batch_size=4, max_slab_rows=1), 3, id="three_slabs"),
    pytest.param(dict(batch_size=4, blend_mode="gaussian"), 3,
                 id="gaussian"),
    pytest.param(dict(batch_size=4, affinity_mode=False), 3, id="mask"),
    pytest.param(dict(batch_size=4, out_path="aff.zarr"), 3, id="out_path"),
])
def test_streamed_predict_equals_slab_at_once(vol, runners, tmp_path, kw,
                                              chunks):
    """Bit for bit, and the chunk count: the planes before the first row's
    trimmed output make a chunk of their own when the first batch leaves
    part of that row to come."""
    kw = dict(GRID, **kw)
    out_path = kw.pop("out_path", None)
    runner = runners[kw.get("affinity_mode", True)]
    want = slab_at_once(vol, runner, **kw)
    before = inference.predict.copy_out_chunks
    if out_path is None:
        got = inference.predict(vol, runner, verbose=False, **kw)
    else:
        got = inference.predict(vol, runner, verbose=False,
                                out_path=str(tmp_path / out_path), **kw)[:]
    assert inference.predict.copy_out_chunks == before + chunks
    assert_same_bits(got, want)


@pytest.mark.parametrize("z, batch_size, trim, own, chunks", [
    # the benchmark's 256^3 block: 4 rows of 16 patches, batch 16
    ([0] * 16 + [64] * 16 + [128] * 16 + [192] * 16, 16, 8, (0, 256),
     {0: (0, 72), 16: (72, 136), 32: (136, 200), 48: (200, 256)}),
    ([0, 0, 16, 16, 32, 32], 2, 4, (0, 64),
     {0: (0, 20), 2: (20, 36), 4: (36, 64)}),
    ([0, 0, 16, 16, 32, 32], 1, 4, (0, 64),
     {0: (0, 4), 1: (4, 20), 3: (20, 36), 5: (36, 64)}),
    ([0, 0, 16, 16, 32, 32], 4, 4, (0, 64), {0: (0, 36), 4: (36, 64)}),
    # a later slab: its first row is recomputed, below its owned planes
    ([0, 0, 16, 16], 2, 4, (20, 36), {2: (20, 36)}),
], ids=["256_batch16", "batch_a_row", "half_rows", "straddle",
        "recomputed_row"])
def test_chunk_plan(z, batch_size, trim, own, chunks):
    assert inference._chunk_plan(z, batch_size, trim, own) == chunks
