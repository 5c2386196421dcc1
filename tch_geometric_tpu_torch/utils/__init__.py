from .config import (
    TEMPORAL_SAMPLE_DYNAMIC,
    TEMPORAL_SAMPLE_RELATIVE,
    TEMPORAL_SAMPLE_STATIC,
    EdgeSampler,
    TemporalEdgeFilter,
    UniformEdgeSampler,
    WeightedEdgeSampler,
    validate_mixeddata,
)
from .params import sage_params_from_flax
from .types import (NAN_TIMESTAMP, EdgeType, NodeType, RelType, TypeIndex,
                    rel_key, split_rel_key, to_edge_types)
