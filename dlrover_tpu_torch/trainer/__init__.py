from dlrover_tpu_torch.trainer.train_step import (  # noqa: F401
    TrainConfig,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
