"""Layer ops on NHWC tensors, and the hand-written Hopper kernels
(``ops/kernels/``) that replace the JAX package's Pallas kernels."""

from znicz_tpu_torch.ops import accumulator  # noqa: F401
from znicz_tpu_torch.ops import activation  # noqa: F401
from znicz_tpu_torch.ops import all2all  # noqa: F401
from znicz_tpu_torch.ops import conv  # noqa: F401
from znicz_tpu_torch.ops import cutter  # noqa: F401
from znicz_tpu_torch.ops import deconv  # noqa: F401
from znicz_tpu_torch.ops import dropout  # noqa: F401
from znicz_tpu_torch.ops import kohonen  # noqa: F401
from znicz_tpu_torch.ops import normalization  # noqa: F401
from znicz_tpu_torch.ops import pooling  # noqa: F401
from znicz_tpu_torch.ops import rbm  # noqa: F401
from znicz_tpu_torch.ops import resizable_all2all  # noqa: F401
from znicz_tpu_torch.ops import weights_zerofilling  # noqa: F401
