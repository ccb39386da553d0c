"""Forest build and query, the fused pipeline, exact k-NN and search helpers."""
