"""The yardstick's counts against hand-counted small shapes."""

import numpy as np

import bench_tiny  # noqa: F401  (puts the benchmark on the path)
from okbench import work


def test_lstm_products_hand_counted():
    # 3 rows of lengths 1, 2, 3 (6 row-steps), D = 4, H = 2: the input
    # product 2*D*4H = 64 FLOP a row-step, the recurrent 2*H*4H = 32 from each
    # row's second step on (3 of them)
    x, h = work.lstm_products(6, 3, 4, 2)
    assert (x, h) == (6 * 64, 3 * 32)


def test_step_work_hand_counted():
    # entity rows: 0, 1 (UNK), then mentions 2.. of lengths 2, 3, 4; relations likewise
    ent = np.zeros((5, 6), np.int32)
    ent[:2, 0] = 1
    for i, n in enumerate((2, 3, 4)):
        ent[2 + i, :n] = 5
    rel = ent.copy()
    w = work.StepWork({"entity_tokens": ent, "relation_tokens": rel}, dim=2, dtype="bfloat16")
    # two rows, both entity 4 (length 4) -> one distinct query entity; relations 2 and 3
    out = w.step(np.array([4, 4, 0]), np.array([2, 3, 0]), 2, np.array([2, 3, 0, 0]), 2)
    d = 2
    per_x, per_h = 2 * d * 4 * d, 2 * d * 4 * d
    encodes = [(2 + 3, 2), (4, 1), (2 + 3, 2)]  # candidates, distinct query entities, distinct relations
    x = sum(n * per_x for n, _ in encodes)
    h = sum((n - r) * per_h for n, r in encodes)
    score = 2 * 2 * 2 * d
    assert out["model_flops"] == 3 * (x + h) + 3 * score


def test_full_vocabulary_candidates_are_every_entity():
    ent = np.zeros((6, 3), np.int32)
    ent[:, 0] = 1
    w = work.StepWork({"entity_tokens": ent, "relation_tokens": ent}, dim=2, dtype="float32")
    out = w.step(np.array([2]), np.array([2]), 1, None, 4)  # 4 entities from id 2 on, each of length 1
    assert out["model_flops"] == 3 * (4 + 1 + 1) * 2 * 2 * 4 * 2 + 3 * 2 * 1 * 4 * 2
    assert w.peak == 495e12
