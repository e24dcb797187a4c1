"""Training: AdamW and its 8-bit form, int8 error-feedback gradient
compression, and the microbatched train step."""
from .compress import compress_grads, compression_ratio, init_error_state  # noqa: F401
from .optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    adamw_update_8bit,
    global_norm,
    init_opt_state,
    init_opt_state_8bit,
    schedule,
)
from .train_step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
    train_state_from_numpy,
    train_state_from_tree,
    train_state_to_tree,
)
