from .mesh import data_sharding, make_mesh, param_sharding_rule, replicated, shard_params
from .train import (AdamState, GnnTrainer, MultibatchTrainer, TrainState,
                    make_gnn_trainer, make_multibatch_sage_trainer,
                    make_sage_trainer)
from .hgt_train import (HGTTrainer, HGTTrainState, make_hgt_trainer,
                        make_partitioned_hgt_trainer)
from .link_train import (LinkTrainer, make_link_trainer,
                         make_partitioned_link_trainer)
from .resilience import barrier, inject_shard_fault, shard_checksums
from .sharded_features import (build_interleaved_features, halo_gather,
                               make_sharded_feature_trainer)
from .dist_sampling import (PartitionedGraph, build_partitioned_graph,
                            dist_sample_neighbors,
                            make_partitioned_multibatch_trainer,
                            make_partitioned_trainer)
from . import multihost
from .dist_walks import (dist_biased_tempo_random_walk, dist_random_walk,
                         dist_tempo_random_walk, effective_edge_ts)
from .dist_negative import dist_negative_sample, dist_negative_sample_hetero
from .dist_hgt import (StackedRels, build_partitioned_hetero, dist_hgt_sample,
                       put_stacked_rels, stack_partitioned_rels)
from .dist_hetero import dist_hetero_neighbor_sample, merge_rank_blocks
from .dist_budget import dist_budget_sample, dist_budget_sample_hetero
