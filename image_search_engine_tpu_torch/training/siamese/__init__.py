"""Siamese metric-learning trainer: DenseNet-121 backbone + 128-D embedding
head, triplet/circle losses, augmentation-positive pairing, best-val
checkpointing with resume, index building, evaluation and HTTP serving.
Port of ``image_search_engine_tpu/training/siamese``."""
