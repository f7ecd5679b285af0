from repro_torch.optim.adamw import Optimizer, adamw, apply_updates
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm", "cosine_warmup",
           "global_norm"]
