"""repro_torch.training: AdamW, the train loop and checkpoints
(``repro.training``)."""
