"""open_knowledge_graph_embeddings_tpu_torch — the PyTorch and CUDA port of
open_knowledge_graph_embeddings_tpu, for one NVIDIA H100.

The JAX package beside it is the reference: each module here keeps the name
of its counterpart there, and the tests feed the same inputs and weights
through both.  The port imports nothing of JAX or of the JAX package.  Every
Pallas kernel of the JAX package becomes a kernel written by hand for Hopper
(``csrc/``), next to a plain PyTorch version of the same function that CPU
tensors take.

Ported so far, for the LSTM token models in bf16 and f32: top-k serving
(``cli.predict``, ``inference.Predictor``), training with BCE and Adagrad or
SGD (``cli.train``, the row-sparse step of ``train/sparse.py``), fused and
unfused, and filtered-ranking evaluation with model selection and early
stopping (``cli.train --evaluate``, ``train/evaluate.py``); every Pallas
kernel of the JAX package has its CUDA counterpart (``ops/``, ``csrc/``).
Benchmark creation (``cli.create_data``, ``preprocessing/``) is host code
and writes the JAX package's files byte for byte; checkpoints load from
either package, the per-shard format of multi-process runs included.
"""

__version__ = "0.1.0"
