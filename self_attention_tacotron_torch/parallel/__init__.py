from .train_step import (TrainState, create_train_state, make_eval_step,
                         make_optimizer, make_predict_step, make_train_step)

__all__ = ["TrainState", "create_train_state", "make_eval_step",
           "make_optimizer", "make_predict_step", "make_train_step"]
