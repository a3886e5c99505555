"""The architecture seam moved no reading of the cells it was cut from.

The constants are the readings of the benchmark as it was before the
seam (the UNet3D called directly), taken on the CPU at the sizes of
``cpu/<cell>.json`` on two seeds: digests of the seeded weights, the
predict check's gaps after one call on each block of the pool, the
controls' readings, and every metric reader on one hand-built record.
"""

import hashlib
import types

import pytest
import torch

from benchmark import calibrate, harness, inputs
from benchmark.models import unet3d
from benchmark.tests.test_bench_checks import cpu_sizes
from benchmark.trace import Trace

CPU = torch.device("cpu")
SEEDS = (2**31 + 11, 2**31 + 12)

# sha256 over every (key, float32 bytes) in key order
CALIBRATED = {
    2**31 + 11:
        "050021ebe0c6e4da163ff5ba880bfbffc3b29e82080e661c9e5fb7d6f9988ee0",
    2**31 + 12:
        "6eeb205a8a5e5f8225cf6e7e284e0e30e1d911a124bc5580f7fc953cc2abbb31",
}
CONV = {
    2**31 + 11:
        "fdc07e2d84463344fcb8f541b71d3d2679e625ff035a2395721214925efefe84",
    2**31 + 12:
        "568f9538910e4f4731dead3ac5ab499583cdf5830217f3197381136fa869435a",
}
PREDICT_CHECK = {
    2**31 + 11: {"aff_mae": 8.587737571064125e-08,
                  "aff_max_abs": 2.4139881134033203e-06},
    2**31 + 12: {"aff_mae": 7.871191106308591e-08,
                  "aff_max_abs": 2.682209014892578e-06},
}
CONTROL = {
    ("predict_ram_256", 2**31 + 11): {"control_fp8": {
        "aff_mae": 0.008859360572059216, "aff_max_abs": 0.28512606024742126}},
    ("predict_ram_256", 2**31 + 12): {"control_fp8": {
        "aff_mae": 0.007818928419370744, "aff_max_abs": 0.1958736777305603}},
    ("train_pool_b16", 2**31 + 11): {
        "control_fp8": {
            "input_gap": 0.0,
            "loss_gap_first": 0.004360618694582912,
            "loss_gap": 0.002028905720833707,
            "grad_gap": 0.21641103498974287,
            "grad_gap_median": 0.020176223818662437,
            "update_gap": 0.14804526028868242,
            "update_gap_median": 0.014488135087404132,
        },
        "fault_half_batch": {
            "input_gap": 0.0,
            "loss_gap_first": 0.0047680293662329155,
            "loss_gap": 0.01158775274979613,
            "grad_gap": 0.5797538597003651,
            "grad_gap_median": 0.11330867057823976,
            "update_gap": 0.18480141070729203,
            "update_gap_median": 0.021469803910128038,
        },
        "fault_flip_targets": {
            "input_gap": 0.0,
            "loss_gap_first": 0.10649272790374711,
            "loss_gap": 0.22873763895878732,
            "grad_gap": 2.0670862134954855,
            "grad_gap_median": 0.5218379733473617,
            "update_gap": 0.2897170893916395,
            "update_gap_median": 0.06960542885036625,
        },
    },
    ("train_pool_b16", 2**31 + 12): {
        "control_fp8": {
            "input_gap": 0.0,
            "loss_gap_first": 0.0030232788476029235,
            "loss_gap": 0.004793893665635693,
            "grad_gap": 0.22553647435932142,
            "grad_gap_median": 0.0299552673258216,
            "update_gap": 0.13471870316156523,
            "update_gap_median": 0.017664578059172507,
        },
        "fault_half_batch": {
            "input_gap": 0.0,
            "loss_gap_first": 0.0019042410640038696,
            "loss_gap": 0.0072416538447943445,
            "grad_gap": 0.7439862019276672,
            "grad_gap_median": 0.1905481877089563,
            "update_gap": 0.3343350461240952,
            "update_gap_median": 0.04075350500113979,
        },
        "fault_flip_targets": {
            "input_gap": 0.0,
            "loss_gap_first": 0.04626111860295324,
            "loss_gap": 0.08784026611250724,
            "grad_gap": 3.3382628815758992,
            "grad_gap_median": 1.0871130330585403,
            "update_gap": 0.3124879460701138,
            "update_gap_median": 0.06040845172252718,
        },
    },
}
READERS = {
    "affinity_mvox_s": 577.0654437055721,
    "backward_device_ms.train": 7.0,
    "bn_roofline.train": 154.82146388059704,
    "conv_roofline.predict": 98.33644330192114,
    "conv_roofline.train": 119.59898820206271,
    "device_idle.predict": 5.434533363907368,
    "device_idle.train": 5.434533363907368,
    "forward_device_ms.train": 3.5,
    "idle_copy_out.predict": 2.293052052281587,
    "idle_prep.predict": 0.5732630130703967,
    "idle_upload.predict": 0.45861041045631734,
    "input_device_ms.train": 0.8,
    "input_wait.train": 2.293052052281587,
    "k1_roofline.predict": 79.71916417910448,
    "mfu.predict": 67.64717493826264,
    "mfu.train": 64792119.88113322,
    "optimizer_device_ms.train": 0.05,
    "setup_s": 12.5,
    "step_device_ms.train": 11.45,
    "train_patches_s": 577065443.7055721,
}


def digest(params):
    """sha256 of a weight dict's keys and float32 bytes, in key order."""
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _inputs(cell):
    return harness.cell_inputs(harness.load_spec(), cell, cpu_sizes(cell))


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_are_the_same_bits(seed):
    cfg, t = _inputs("predict_ram_256")
    block = inputs.tube_volume(seed, 0, t["block"], t["tubes"], t["radius"],
                               t["noise"], t["bright"])[0]
    arch = harness.model_module(cfg)
    assert digest(arch.weights(cfg, seed, CPU, block)) == CALIBRATED[seed]
    m = cfg["model"]
    assert digest(unet3d.conv_weights(seed, CPU, m["width"],
                                      m["out_channels"])) == CONV[seed]


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_check_reads_the_same(seed):
    cfg, traffic = _inputs("predict_ram_256")
    driver = harness.load_module("drivers", traffic["driver"] + ".py")
    session = driver.setup(types.SimpleNamespace(
        cfg=cfg, traffic=traffic, seed=seed, device=CPU, trace=False))
    for _ in range(traffic["pool"]):
        session.step()
    session.free()
    assert dict(session.check()) == PREDICT_CHECK[seed]


@pytest.mark.parametrize("cell,seed", [(c, s) for c, s in CONTROL])
def test_control_reads_the_same(cell, seed):
    got = calibrate.control_readings(cell, seed, CPU, cpu_sizes(cell))
    assert {kind: {k: v for k, v in numbers if k != "worst_leaves"}
            for kind, numbers in got.items()} == CONTROL[cell, seed]


def hand_record():
    """A run's record in which every reader finds something: the two
    cells' configurations and traffic merged, the H100's peaks, and a
    trace of three predict blocks (4 convs and 4 K1 launches each, under
    predict's spans) and four train steps (input, forward, backward,
    optimizer)."""
    spec = harness.load_spec()
    cfg, traffic = {}, {}
    for cell in ("predict_ram_256", "train_pool_b16"):
        c, t = harness.cell_inputs(spec, cell)
        cfg, traffic = harness.merged(cfg, c), harness.merged(traffic, t)
    device, host, now = [], [], 1000.0

    def run(us, name, ops):
        nonlocal now
        device.append((now, now + us, name, ops))
        now += us + 5.0

    host += [(0.0, 400.0, "predict.normalize"), (400.0, 500.0, "predict.pad"),
             (500.0, 900.0, "predict.upload")]
    conv = ["aten::cudnn_convolution", "aten::convolution", "aten::conv3d"]
    for _ in range(3 * 4):
        run(3000.0, "cudnn_conv_fwd", conv)
        run(90.0, "scatter_blend_kernel", ["aten::empty"])
    host.append((now, now + 2000.0, "predict.copy_out"))
    now += 2500.0
    engine = "autograd::engine::evaluate_function: "
    for _ in range(4):
        a = now
        run(800.0, "k_in", ["aten::to", "train.input", "bench.train_batch"])
        b = now
        run(2000.0, "cudnn_conv_fwd", conv + ["train.forward"])
        run(1500.0, "bn_fwd", ["aten::native_batch_norm", "aten::batch_norm",
                               "train.forward"])
        c = now
        run(3000.0, "bn_bwd", ["aten::native_batch_norm_backward",
                               engine + "NativeBatchNormBackward0"])
        run(4000.0, "conv_bwd", ["aten::convolution_backward",
                                 engine + "ConvolutionBackward0"])
        run(50.0, "k_opt", ["aten::_foreach_add_",
                            "Optimizer.step#AdamW.step", "bench.train_batch"])
        host += [(a, b, "train.input"), (b, c, "train.forward"),
                 (c, c + 100.0, "train.backward")]
    t = Trace.__new__(Trace)
    t.start_us, t.end_us, t.thread = 0.0, now + 1000.0, 1
    t.device, t.host, t._union = device, host, None
    return dict(setup_s=12.5, window_s=t.window_s, work=3 * 256**3, calls=3,
                cfg=cfg, traffic=traffic, trace=t,
                peaks=harness.load_json("counts", "peaks.json")["NVIDIA H100"],
                counters={"blocks": 3, "steps": 4, "input_wait_s": 0.002,
                          "step_device_s": [0.0113, 0.0114, 0.0115, 0.0116]})


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_the_same(metric):
    assert harness.load_module("metrics", metric + ".py").read(
        hand_record()) == READERS[metric]

