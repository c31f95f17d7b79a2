"""Serving: KV-page accounting, the block allocator, the wave-batched
dense engine and the continuous-batching paged engine."""
from repro_torch.serve.engine import (  # noqa: F401
    GenerationConfig,
    PagedServeEngine,
    RequestResult,
    ServeEngine,
)
from repro_torch.serve.kvcache import (  # noqa: F401
    BlockAllocator,
    cache_bytes,
    page_bytes,
    pages_for,
    pool_pages,
)
