from repro_torch.data.pipeline import DataConfig, SyntheticDataset, make_batch
