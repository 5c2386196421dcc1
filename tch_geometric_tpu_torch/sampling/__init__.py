from . import primitives, rng
from .neighbor import (NeighborSample, compact_sample,
                       neighbor_sampling_homogenous, sample_neighbors)
