from .attention_blocked import (
    attend_blocked,
    attend_blocked_cuda,
    attend_blocked_flash,
    attend_blocked_flash_cuda,
    attend_blocked_fused,
    attend_blocked_fused_cuda,
    blocked_dst_rows,
    edge_softmax_blocked,
    edge_softmax_blocked_cuda,
    gat_attend_blocked_packed,
    gat_attend_blocked_packed_cuda,
    gat_edge_logits_blocked,
    sddmm_blocked,
    sddmm_blocked_cuda,
    spmm_blocked_weighted_cuda,
)
from .segment import (
    csr_row_ids,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)
from .spmm import sddmm, spmm
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
