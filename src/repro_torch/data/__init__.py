from repro_torch.data.store import (
    ArrayStore,
    EmbeddingStore,
    MemmapStore,
    ShardedStore,
    as_store,
    is_store,
    stream_chunks,
    write_sharded,
)
from repro_torch.data.synthetic import (
    class_token_corpus,
    gaussian_mixture,
    gaussian_mixture_store,
    hierarchical_mixture,
    swiss_roll,
)

__all__ = [
    "ArrayStore",
    "EmbeddingStore",
    "MemmapStore",
    "ShardedStore",
    "as_store",
    "class_token_corpus",
    "gaussian_mixture",
    "gaussian_mixture_store",
    "hierarchical_mixture",
    "is_store",
    "stream_chunks",
    "swiss_roll",
    "write_sharded",
]
