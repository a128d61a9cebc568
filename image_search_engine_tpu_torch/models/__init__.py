"""CNN backbones (torch.nn) and the batched embedder."""
