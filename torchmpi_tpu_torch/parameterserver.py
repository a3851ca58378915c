"""``torchmpi_tpu_torch.parameterserver`` — the ``torchmpi.parameterserver``
integration surface, the counterpart of ``torchmpi_tpu/parameterserver.py``:
a thin facade over :mod:`torchmpi_tpu_torch.parallel.ps` keeping the
reference's module layout and verbs (init / send / receive / syncHandle)."""

from .parallel.ps import (  # noqa: F401
    RULES,
    PSHandle,
    PSClient,
    ShardedParameterServer,
    ParameterServer,
    sync_handle,
)


def init(template, num_shards: int = 2, **kw) -> ParameterServer:
    """Reference: ``parameterserver.init(flatParams)`` — starts shard servers
    and connects a client, seeding shards with ``template``'s values (a
    tree of tensors on the card, of CPU tensors or of numpy arrays)."""
    return ParameterServer(template, num_shards=num_shards, **kw)
