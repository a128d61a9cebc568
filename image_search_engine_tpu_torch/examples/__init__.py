"""Runnable examples of the port (``python -m image_search_engine_tpu_torch.examples.<name>``)."""
