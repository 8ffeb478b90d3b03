from repro_torch.optim.optimizers import (Optimizer, adamw, make_optimizer,
                                          sgd_momentum, value_and_grad)
from repro_torch.optim.schedules import constant, cosine_warmup, step_lr
