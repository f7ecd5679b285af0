from repro_torch.optim.adamw import Optimizer, adamw, adamw8bit, apply_updates
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.grad_compress import compress_decompress_gradient
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["Optimizer", "adamw", "adamw8bit", "apply_updates", "clip_by_global_norm",
           "compress_decompress_gradient", "cosine_warmup", "global_norm"]
