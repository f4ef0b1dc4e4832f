"""Evaluation-set sampling (capability P7; the port's copy of
``open_knowledge_graph_embeddings_tpu/preprocessing/sampling.py``).  It
draws with ``np.random.default_rng(seed)``, as the JAX package does, so
both packages sample the same triples.

Samples three disjoint evaluation sets from the aggregated triple list
(reference: preprocessing/sample_evaluation_data.py:17-103):

* ``validation``: any triple whose relation has >= ``min_relation_tokens``
  tokens,
* ``validation_linked``: triples with *both* slots entity-linked,
* ``test``: triples with both slots linked, disjoint from the above.
"""

from __future__ import annotations

from typing import List, Sequence, Set, Tuple

import numpy as np

from open_knowledge_graph_embeddings_tpu_torch.preprocessing.leakage import LinkedTriple


def sample_evaluation_data(
    triples: Sequence[LinkedTriple],
    eval_size: int,
    min_relation_tokens: int = 3,
    seed: int = 0,
) -> Tuple[List[int], List[int], List[int]]:
    """Returns (validation_ids, validation_linked_ids, test_ids) — indices
    into ``triples``, mutually disjoint."""
    rng = np.random.default_rng(seed)
    n = len(triples)
    order = rng.permutation(n)

    taken: Set[int] = set()

    def take(pred, k):
        out = []
        for i in order:
            if len(out) >= k:
                break
            if i in taken:
                continue
            if pred(triples[i]):
                out.append(int(i))
                taken.add(int(i))
        return out

    # all three sets draw from long-relation triples; the linked sets
    # additionally require both slots entity-linked
    # (reference: sample_evaluation_data.py:42-45)
    long_relation = lambda t: len(t[0][1]) >= min_relation_tokens
    linked_long = lambda t: (
        long_relation(t) and t[1][0] is not None and t[1][1] is not None
    )

    validation_ids = take(long_relation, eval_size)
    validation_linked_ids = take(linked_long, eval_size)
    test_ids = take(linked_long, eval_size)
    return validation_ids, validation_linked_ids, test_ids
