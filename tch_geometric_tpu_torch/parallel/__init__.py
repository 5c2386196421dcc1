from .train import (AdamState, GnnTrainer, MultibatchTrainer, TrainState,
                    make_gnn_trainer, make_multibatch_sage_trainer,
                    make_sage_trainer)
