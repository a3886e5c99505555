"""Multi-rank inference: rank meshes, sharded order statistics and
``predict_sharded`` over ``torch.distributed`` (one device per rank)."""

from aind_exaspim_neuron_segmentation_tpu_torch.parallel.mesh import (  # noqa: F401
    RankMesh,
    initialize_distributed,
    make_mesh,
    make_mesh_2d,
)
from aind_exaspim_neuron_segmentation_tpu_torch.parallel.sharded_inference import (  # noqa: F401,E501
    predict_sharded,
)
from aind_exaspim_neuron_segmentation_tpu_torch.parallel.stats import (  # noqa: F401
    order_stat,
    percentile_device,
    percentile_sharded,
)
