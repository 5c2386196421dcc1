from . import primitives, rng
from .budget import (BudgetSample, budget_sampling, compact_budget_sample,
                     sample_budget)
from .hetero_neighbor import (HeteroNeighborSample, compact_hetero_sample,
                              neighbor_sampling_heterogenous,
                              sample_hetero_neighbors)
from .hgt import HGTSample, compact_hgt_sample, hgt_sampling, sample_hgt
from .negative import (negative_sample_neighbors_heterogenous,
                       negative_sample_neighbors_homogenous)
from .neighbor import (NeighborSample, compact_sample,
                       neighbor_sampling_homogenous, sample_edges_uniform,
                       sample_neighbors, split_sample_batches)
from .walks import biased_tempo_random_walk, random_walk, tempo_random_walk
