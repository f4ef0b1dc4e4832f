"""Embedders and the scorer x embedder model registry."""
