"""Logging, device selection and the CUDA build helper."""
