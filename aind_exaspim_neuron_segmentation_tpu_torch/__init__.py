"""PyTorch/CUDA port of the ExaSPIM neuron segmentation framework.

Runs the inference main path ``inference.load_model`` ->
``inference.predict`` on an NVIDIA Hopper GPU: the UNet3D forward in
PyTorch (cuDNN convolutions, trilinear ``F.interpolate``), and the
overlap-blend scatter-add as a hand-written CUDA kernel
(``csrc/scatter_blend.cu``, built with ``nvcc`` at first use). The tail
``inference.affinities_to_segmentation`` ->
``inference.segmentation_to_zipped_swcs`` runs on the host through the
port's own C++ engine (``native/src``: watershed, agglomeration, remap,
EDT, TEASAR; built with ``g++`` at first use) and ``postprocess``; it
takes the float affinities or the u8 digest pair the card made.

Volumes beyond host RAM stream: ``io.read`` opens a zarr / N5 store (or
reads a TIFF) through the port's own codecs, ``predict`` reads a lazy
handle slab by slab and writes ``out_path`` stores, the segmentation of
a lazy handle runs the slab-streaming engine, and TEASAR of a lazy label
store runs per-label crops. ``python -m
aind_exaspim_neuron_segmentation_tpu_torch run`` chains the three.

Training (``machine_learning.Trainer`` on the numpy datasets, with the
augmentation on the device, ``ops.augment_device``; ``python -m
aind_exaspim_neuron_segmentation_tpu_torch train``) writes the best-F1
``.pth`` that ``load_model`` reads.

Several devices or hosts run one job through ``parallel`` and
``torch.distributed`` (one process per device): ``predict_sharded``
splits the patch grid over a rank mesh with halo exchange, and
``postprocess.segment_streaming_sharded`` / ``skeletonize_sharded``
split the tail; the CLI's ``--distributed`` chains them.

The JAX package ``aind_exaspim_neuron_segmentation_tpu`` is the numerical
reference; this package imports nothing from it and never imports JAX.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy submodule access: keep the package import lightweight."""
    import importlib

    if name in ("core", "cuda_build", "inference", "io", "machine_learning",
                "models", "native", "ops", "parallel", "postprocess",
                "utils"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
