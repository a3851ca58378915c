"""Models of the port (the JAX package's ``torchmpi_tpu.models``)."""

from .transformer import (  # noqa: F401
    Block,
    SPAttention,
    TransformerLM,
    apply_rope,
)
