from repro_torch.optim.optimizers import Optimizer, adamw, sgd  # noqa: F401
from repro_torch.optim.schedules import (constant_lr, cosine_lr,  # noqa: F401
                                         step_decay_lr, warmup_cosine_lr)
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
