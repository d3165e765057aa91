"""The port's data layer: host decode, datasets and loaders (numpy, no
torch), device prefetch, and device preprocessing. Importing the package
registers the datasets in ``registry.DATASETS``; ``cv2`` and ``av`` are
imported only when a real decode backend needs them."""

from avid_cma_tpu_torch.data.decode import (  # noqa: F401
    DecodeBackend,
    FFmpegCLIBackend,
    PyAVBackend,
    SyntheticBackend,
    make_backend,
)
from avid_cma_tpu_torch.data.video_db import VideoDataset  # noqa: F401
from avid_cma_tpu_torch.data.datasets import HMDB, UCF, AudioSet, Kinetics  # noqa: F401
from avid_cma_tpu_torch.data.learnable import LearnableAV, LearnableAVBackend  # noqa: F401
from avid_cma_tpu_torch.data.loader import (  # noqa: F401
    CachedDataLoader,
    DataLoader,
    MultiprocessDataLoader,
    ShardedBatchSampler,
)
