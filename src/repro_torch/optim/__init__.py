from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, cosine_lr, global_norm
from repro_torch.optim.compress import compress_with_error_feedback, init_error_state
