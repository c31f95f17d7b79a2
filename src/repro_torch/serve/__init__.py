"""Paged serving: KV-page accounting, the block allocator and the
continuous-batching engine."""
from repro_torch.serve.engine import (  # noqa: F401
    GenerationConfig,
    PagedServeEngine,
    RequestResult,
)
from repro_torch.serve.kvcache import (  # noqa: F401
    BlockAllocator,
    cache_bytes,
    page_bytes,
    pages_for,
    pool_pages,
)
