"""Gallery index and encoders (port of hairci.retrieval)."""

from hairci_torch.retrieval.sharded import (  # noqa: F401
    ShardedGalleryIndex,
    sharded_gallery_search,
)
