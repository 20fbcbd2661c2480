"""Range analytics over (sharded) wavelet matrices, and their snapshots."""
from .engine import (ShardedAnalytics, build_sharded_analytics,
                     local_ranges, mask_ranges, sharded_coverage,
                     sharded_range_count, sharded_range_count_bounds,
                     sharded_range_distinct, sharded_range_histogram,
                     sharded_range_histogram_bounds,
                     sharded_range_quantile, sharded_range_quantile_bracket,
                     sharded_range_quantile_fused, sharded_range_topk,
                     sharded_range_topk_greedy)
from .range_ops import (range_count, range_distinct, range_histogram,
                        range_quantile, range_topk, range_topk_greedy,
                        topk_from_histogram, topk_slot_budget)
from .snapshot import (load_analytics, save_analytics, shards_struct,
                       snapshot_meta)

__all__ = [
    "ShardedAnalytics", "build_sharded_analytics", "local_ranges",
    "mask_ranges", "sharded_coverage", "sharded_range_count",
    "sharded_range_count_bounds", "sharded_range_distinct",
    "sharded_range_histogram", "sharded_range_histogram_bounds",
    "sharded_range_quantile", "sharded_range_quantile_bracket",
    "sharded_range_quantile_fused", "sharded_range_topk",
    "sharded_range_topk_greedy", "range_count", "range_distinct",
    "range_histogram", "range_quantile", "range_topk", "range_topk_greedy",
    "topk_from_histogram", "topk_slot_budget", "load_analytics",
    "save_analytics", "shards_struct", "snapshot_meta",
]
