"""The benchmark of the PyTorch and CUDA port: its harness, yardstick and
plain reference (see ``benchmark/run.py``)."""
