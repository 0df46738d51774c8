"""Distance, kNN, root-search, sparse and kernel primitives."""
