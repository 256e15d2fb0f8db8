"""Training of the PyTorch port: the train step (autograd, optimizer,
microbatching, gradient compression) and the fault-tolerant trainer."""
from repro_torch.train.steps import init_residuals, make_train_step
from repro_torch.train.trainer import (
    SimulatedFailure,
    StepWatchdog,
    Trainer,
    TrainerConfig,
    run_with_restarts,
)

__all__ = ["make_train_step", "init_residuals", "Trainer", "TrainerConfig",
           "SimulatedFailure", "StepWatchdog", "run_with_restarts"]
