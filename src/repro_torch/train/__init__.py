"""Training of the port (``repro.train``): the loss and the single-card
step."""
from repro_torch.train.loss import cross_entropy  # noqa: F401
from repro_torch.train.step import make_eval_step, make_train_step  # noqa: F401
