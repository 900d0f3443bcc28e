from repro_torch.ckpt import checkpoint
from repro_torch.ckpt.manager import CheckpointManager
