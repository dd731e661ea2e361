from repro_torch.train.step import (TrainState, init_train_state,
                                    loss_and_grads, make_train_step)
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.loop import (FailureInjector, LoopConfig,
                                    StragglerWatchdog, TrainResult, train)

__all__ = ["TrainState", "init_train_state", "loss_and_grads",
           "make_train_step", "Checkpointer", "FailureInjector",
           "LoopConfig", "StragglerWatchdog", "TrainResult", "train"]
