"""Range analytics over (sharded) wavelet matrices."""
from .engine import (ShardedAnalytics, build_sharded_analytics,
                     sharded_range_count, sharded_range_quantile,
                     sharded_range_quantile_fused)
from .range_ops import range_count, range_quantile

__all__ = [
    "ShardedAnalytics", "build_sharded_analytics", "sharded_range_count",
    "sharded_range_quantile", "sharded_range_quantile_fused", "range_count",
    "range_quantile",
]
