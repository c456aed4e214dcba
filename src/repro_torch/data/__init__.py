"""Training data: :class:`~repro_torch.data.pipeline.SyntheticTextDataset`."""
