"""Input pipeline of the port: uint8 image streams served per resolution.

The host serves raw uint8 batches; normalization to [-1, 1] and the random
horizontal flip happen on the device inside the training step. A
background-thread ``Prefetcher`` keeps the next batches ready and already
on the device. ``prepare_dataset`` turns an image folder into the ``.npy``
shards ``NpySource`` serves.
"""

from ganlab_tpu_torch.data.pipeline import (
    ArraySource,
    Cifar10Source,
    EllipsesSource,
    ImageFolderSource,
    NpySource,
    Prefetcher,
    SyntheticSource,
    box_downsample,
    device_placer,
    make_source,
)
from ganlab_tpu_torch.data.prepare import prepare_dataset
