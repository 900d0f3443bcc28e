from repro_torch.train import losses, optimizer, train_state
from repro_torch.train.optimizer import AdamWConfig
