from .attention_blocked import spmm_blocked_weighted_cuda
from .segment import csr_row_ids, segment_mean, segment_sum
from .spmm import spmm
from .spmm_blocked import (
    BlockedCsr,
    HotSplitCsr,
    HotSplitSeg,
    SegmentedBlockedCsr,
    build_blocked,
    build_blocked_hot,
    build_blocked_hot_segmented,
    build_blocked_segmented,
    edge_attr_to_blocked,
    spmm_blocked,
)
from .spmm_kernels import (
    spmm_blocked_auto,
    spmm_blocked_cuda,
    spmm_blocked_segmented,
    spmm_hot_split,
    spmm_hot_split_segmented,
)
