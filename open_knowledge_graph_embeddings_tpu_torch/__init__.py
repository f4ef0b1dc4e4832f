"""open_knowledge_graph_embeddings_tpu_torch — the PyTorch and CUDA port of
open_knowledge_graph_embeddings_tpu, for one NVIDIA H100.

The JAX package beside it is the reference: each module here keeps the name
of its counterpart there, and the tests feed the same inputs and weights
through both.  The port imports nothing of JAX or of the JAX package.  Every
Pallas kernel of the JAX package becomes a kernel written by hand for Hopper
(``csrc/``), next to a plain PyTorch version of the same function that CPU
tensors take.

Ported so far: top-k serving of the LSTM token models (``cli.predict``,
``inference.Predictor``) with the fused last-state LSTM forward as a CUDA
kernel (``ops/lstm_kernel.py``).
"""

__version__ = "0.1.0"
