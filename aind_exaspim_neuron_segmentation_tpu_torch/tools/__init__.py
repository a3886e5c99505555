"""Measurement tools, each run as ``python -m
aind_exaspim_neuron_segmentation_tpu_torch.tools.<name>``:

* :mod:`.beyond_ram_proof` -- an N^3 float affinity store streamed to
  labels and an SWC zip while the host RSS is sampled; ``--ranks K`` runs
  the same store over K processes, its zip entry-identical;
* :mod:`.traffic_audit` -- the device-memory bytes of each aten op of the
  UNet3D forward against a minimal-traffic model.
"""
