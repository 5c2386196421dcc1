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
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .metrics import (MetricsLogger, profile, span_ms, span_records,
                      trace_span)
from .params import (adam_state_from_optax, gnn_params_from_flax,
                     hgt_params_from_flax, load_flax_params,
                     node2vec_params_from_flax, sage_params_from_flax,
                     train_state_from_flax)
from .types import (NAN_TIMESTAMP, EdgeType, NodeType, RelType, TypeIndex,
                    rel_key, split_rel_key, to_edge_types)
