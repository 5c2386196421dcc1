from . import primitives, rng
from .hetero_neighbor import (HeteroNeighborSample, compact_hetero_sample,
                              neighbor_sampling_heterogenous,
                              sample_hetero_neighbors)
from .neighbor import (NeighborSample, compact_sample,
                       neighbor_sampling_homogenous, sample_edges_uniform,
                       sample_neighbors, split_sample_batches)
