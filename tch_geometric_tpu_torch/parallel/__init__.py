from .train import GnnTrainer, make_gnn_trainer
