"""Training stack: Trainer, datasets, host augmentation."""

from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning.augmentation import (  # noqa: F401,E501
    ImageTransforms,
)
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning.data_handling import (  # noqa: F401,E501
    BaseDataset,
    TrainDataset,
    ValidateDataset,
)
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning.train import (  # noqa: F401,E501
    Trainer,
)
