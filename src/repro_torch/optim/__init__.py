from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          opt_state_defs, sgd_momentum)
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup
