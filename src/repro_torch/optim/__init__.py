from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: F401
                                     adamw_update, clip_by_global_norm,
                                     global_norm)
from repro_torch.optim.loss_scale import (LossScaleState,  # noqa: F401
                                          check_finite, init_loss_scale,
                                          update_loss_scale)
from repro_torch.optim.schedules import warmup_cosine  # noqa: F401
