from .train import (AdamState, GnnTrainer, MultibatchTrainer, TrainState,
                    make_gnn_trainer, make_multibatch_sage_trainer,
                    make_sage_trainer)
from .hgt_train import HGTTrainer, HGTTrainState, make_hgt_trainer
from .link_train import LinkTrainer, make_link_trainer
