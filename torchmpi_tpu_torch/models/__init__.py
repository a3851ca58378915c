"""Models of the port (the JAX package's ``torchmpi_tpu.models``)."""

from . import layers  # noqa: F401
from .alexnet import AlexNet  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock,
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet20,
    ResNet50,
    ResNet101,
    ResNet152,
)
from .transformer import (  # noqa: F401
    Block,
    KVCache,
    SPAttention,
    TransformerLM,
    apply_rope,
)
from .generate import beam_search, generate  # noqa: F401
