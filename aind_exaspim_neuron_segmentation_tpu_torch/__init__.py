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

The JAX package ``aind_exaspim_neuron_segmentation_tpu`` is the numerical
reference; this package imports nothing from it and never imports JAX.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy submodule access: keep the package import lightweight."""
    import importlib

    if name in ("core", "cuda_build", "inference", "models", "native",
                "ops", "postprocess"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
