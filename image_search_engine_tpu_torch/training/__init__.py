"""Training: the siamese metric-learning trainer (``training/siamese``)."""
