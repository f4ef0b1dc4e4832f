"""Special ids of the mapped-to-ids contract: PAD=0, UNK=1 for item
vocabularies, plus BOS=2, EOS=3 for token vocabularies (the same ids as
``open_knowledge_graph_embeddings_tpu/data/vocab.py``)."""

PAD = 0
UNK = 1
BOS = 2
EOS = 3
