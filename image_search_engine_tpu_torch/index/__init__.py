"""Device-resident vector store and the flat exact index."""
