"""Checkpoints cross between the packages, and the port's Predictor and
``cli.predict --device cpu`` give JAX's top-k."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from open_knowledge_graph_embeddings_tpu.cli.predict import main as jax_predict_main
from open_knowledge_graph_embeddings_tpu.data.dataset import load_meta as jax_load_meta
from open_knowledge_graph_embeddings_tpu.inference import Predictor as JaxPredictor
from open_knowledge_graph_embeddings_tpu.models import build_model as jax_build_model
from open_knowledge_graph_embeddings_tpu.train import checkpoint as jax_ckpt
from open_knowledge_graph_embeddings_tpu_torch import inference
from open_knowledge_graph_embeddings_tpu_torch.cli.predict import main as port_predict_main
from open_knowledge_graph_embeddings_tpu_torch.data.dataset import load_meta
from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
from open_knowledge_graph_embeddings_tpu_torch.train import checkpoint
from open_knowledge_graph_embeddings_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODEL = "LSTMComplexRelationModel"
CFG = dict(entity_slot_size=128, normalize="batchnorm", init_std=0.1, sparse=True)
# f32 model: the same f32 products summed in another order
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A synthetic dataset, a JAX model with a checkpoint, and its config."""
    d = tmp_path_factory.mktemp("serve")
    data = d / "data"
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_synth_olpbench.py"), str(data),
         "--mentions", "300", "--relations", "30", "--triples", "200",
         "--eval-size", "20", "--ent-tokens", "100", "--rel-tokens", "25", "--seed", "2"],
        check=True, capture_output=True, timeout=120,
    )
    jmeta = jax_load_meta(str(data), (10, 10))
    jmodel = jax_build_model(MODEL, jmeta, **CFG)
    jv = jmodel.init(jax.random.key(3))
    ck = jax_ckpt.save_checkpoint(str(d), "ck", jv, {}, {"training_steps": 1})
    cfg = d / "cfg.yaml"
    cfg.write_text(
        f"dataset_dir: {data}\nmodel: {MODEL}\nmodel_config: {CFG!r}\n".replace("'", "")
        .replace("True", "true")
    )
    return str(data), jmodel, jv, ck, str(cfg)


def _port_predictor(data, ck):
    meta = load_meta(data, (10, 10))
    model = build_model(MODEL, meta, **CFG)
    variables, meta_json = checkpoint.load_checkpoint(ck, model.init(torch.Generator().manual_seed(0)))
    assert meta_json["training_steps"] == 1
    return inference.Predictor(model, variables, dataset_dir=data)


@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
@pytest.mark.parametrize("direction", ["subj", "obj"])
def test_predictor_matches_jax(served, monkeypatch, chunked, direction):
    data, jmodel, jv, ck, _ = served
    if chunked:  # the OLPBench-size path, on a small vocabulary
        monkeypatch.setattr(inference, "CHUNKED_ABOVE", 0)
    port = _port_predictor(data, ck)
    ref = JaxPredictor(jmodel, jv)
    rng = np.random.default_rng(4)
    ents = rng.integers(2, port.meta.entities_size, 24)
    rels = rng.integers(2, port.meta.relations_size, 24)
    want_s, want_i = ref.predict(**{direction: ents}, rel=rels, k=10)
    got_s, got_i = port.predict(**{direction: ents}, rel=rels, k=10)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, **SCORE_TOL)


def _cli_lines(main, argv, capsys):
    main(argv)
    out = capsys.readouterr().out
    return [ln.split(None, 2) for ln in out.splitlines() if ln.strip()]


def test_cli_predict_cpu_matches_jax(served, capsys):
    data, _, _, ck, cfg = served
    ents = [ln.split("\t")[0] for ln in open(f"{data}/entity_id_map.txt").read().splitlines()[1:4]]
    rels = [ln.split("\t")[0] for ln in open(f"{data}/relation_id_map.txt").read().splitlines()[1:3]]
    for query in (f"{ents[0]}|{rels[0]}|?", f"?|{rels[1]}|{ents[2]}"):
        args = [cfg, "--resume", ck, "--query", query, "-k", "5"]
        want = _cli_lines(jax_predict_main, args, capsys)
        got = _cli_lines(port_predict_main, args + ["--device", "cpu"], capsys)
        assert len(got) == len(want) == 5
        assert [g[2] for g in got] == [w[2] for w in want]  # entity names in rank order
        # printed with 4 decimals: the last digit may round the other way
        np.testing.assert_allclose(
            [float(g[1]) for g in got], [float(w[1]) for w in want], atol=2e-4)


def test_port_checkpoint_loads_into_jax(served, tmp_path):
    data, jmodel, jv, _, _ = served
    meta = load_meta(data, (10, 10))
    model = build_model(MODEL, meta, **CFG)
    pv = model.init(torch.Generator().manual_seed(5))
    path = checkpoint.save_checkpoint(str(tmp_path), "port_ck", pv, {"training_steps": 7})
    loaded, _, meta_json = jax_ckpt.load_checkpoint(path, jv, {}, load_optimizer=False)
    assert meta_json["training_steps"] == 7
    want = {**checkpoint.flatten_arrays(pv["params"], "params"),
            **checkpoint.flatten_arrays(pv["state"], "state")}
    got = {**jax_ckpt.flatten_arrays(loaded["params"], "params"),
           **jax_ckpt.flatten_arrays(loaded["state"], "state")}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_variables_from_jax_arrays_nests_and_skips_opt():
    arrays = {
        "params/entity_lstm/w_ih": np.ones((8, 2), np.float32),
        "params/entity_token_embedding": np.zeros((8, 2), np.float32),
        "state/entity_bn/count": np.float32(3),
        "opt/entity_lstm/w_ih": np.ones((8, 2), np.float32),
    }
    v = checkpoint.variables_from_jax_arrays(arrays)
    assert set(v) == {"params", "state"}
    assert tuple(v["params"]["entity_lstm"]["w_ih"].shape) == (8, 2)
    assert v["state"]["entity_bn"]["count"].shape == ()
    assert float(v["state"]["entity_bn"]["count"]) == 3.0


def test_cuda_device_without_card_raises(served):
    """The entry point runs on the card unless asked for the CPU: without a
    card its default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is served, nothing to refuse")
    data, _, _, ck, cfg = served
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_predict_main([cfg, "--resume", ck, "--query", "a|b|?"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
