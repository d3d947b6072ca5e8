from .state import BatchData, TrainState, create_train_state
from .step import TrainStepConfig, encode_corpus, make_eval_loss_step, make_train_step

__all__ = [
    "BatchData",
    "TrainState",
    "TrainStepConfig",
    "create_train_state",
    "encode_corpus",
    "make_eval_loss_step",
    "make_train_step",
]
