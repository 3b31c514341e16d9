from repro_torch.train.step import (
    cross_entropy,
    make_loss_fn,
    make_train_step,
    make_serve_step,
    init_train_state,
    train_state_axes,
)

__all__ = [
    "cross_entropy",
    "make_loss_fn",
    "make_train_step",
    "make_serve_step",
    "init_train_state",
    "train_state_axes",
]
