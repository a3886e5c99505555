"""Multi-rank work over ``torch.distributed`` (one device per rank): rank
meshes and their placements, sharded order statistics,
``predict_sharded`` and the synchronized BatchNorm of the data-parallel
``Trainer(mesh=)``."""

from aind_exaspim_neuron_segmentation_tpu_torch.parallel.mesh import (  # noqa: F401
    RankMesh,
    initialize_distributed,
    make_mesh,
    make_mesh_2d,
    replicated,
    sharded_first_axis,
)
from aind_exaspim_neuron_segmentation_tpu_torch.parallel.sharded_inference import (  # noqa: F401,E501
    predict_sharded,
)
from aind_exaspim_neuron_segmentation_tpu_torch.parallel.stats import (  # noqa: F401
    order_stat,
    percentile_device,
    percentile_sharded,
)
