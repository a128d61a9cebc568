"""Bag of visual words: the codebook, codeword histograms, BM25 weighting,
cluster-quality scoring and the fit/transform pipeline."""
