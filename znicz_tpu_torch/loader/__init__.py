"""Data loaders (port of ``znicz_tpu/loader``): split bookkeeping,
shuffling from the named PRNG stream, fixed-shape masked minibatches."""

from znicz_tpu_torch.loader.base import (  # noqa: F401
    TEST,
    TRAIN,
    VALID,
    Loader,
    LoaderFetchError,
    Minibatch,
)
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader  # noqa: F401
from znicz_tpu_torch.loader.image import ImageDirectoryLoader  # noqa: F401
from znicz_tpu_torch.loader.imagenet import ImageNetLoader, pack_image_dir  # noqa: F401
from znicz_tpu_torch.loader.prefetch import PrefetchProducerError  # noqa: F401
from znicz_tpu_torch.loader import datasets  # noqa: F401
from znicz_tpu_torch.loader import normalizers  # noqa: F401
