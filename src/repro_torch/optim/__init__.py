from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     clip_by_global_norm, init_opt_state,
                                     lr_at)

__all__ = ["AdamWConfig", "adamw_update", "clip_by_global_norm",
           "init_opt_state", "lr_at"]
