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
from .generate import (  # noqa: F401
    beam_search,
    beam_search_parallel,
    beam_search_parallel_rank_major,
    generate,
    generate_parallel,
    generate_parallel_rank_major,
)
from .pp_generate import (  # noqa: F401
    pp_generate,
    pp_generate_rank_major,
    shard_pp_lm,
)
from .tp_generate import (  # noqa: F401
    init_tp_lm,
    shard_tp_lm,
    tp_beam_search,
    tp_beam_search_rank_major,
    tp_generate,
    tp_generate_rank_major,
)
