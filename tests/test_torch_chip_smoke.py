"""chip_smoke.py on the CPU: it refuses to run without a card, and its LSTM
checks have power.  Without a card the wrappers take the plain versions, so
"kernel" and plain version agree exactly; every fault the script plants must
still fail its rule (at d=64 here; the script plants them at the training
shapes on the card)."""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lstm_case(smoke):
    """One ragged pass at d=64, as the training run hands it to the kernels:
    the forward's inputs and outputs with residuals, and the backward's
    inputs."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    lens = smoke.synth_lengths(np.random.default_rng(0), 300)
    emb, w_ih, w_hh, bias, lens_t, _ = smoke.lstm_inputs(torch, gen, 10, 300, 64, 64, lens)
    args = (emb, w_ih, w_hh, bias, lens_t)
    out = lk.lstm_encode_last_fused(*args)  # no grad: no residuals
    last, hs, cs = lk._forward(*args, residuals=True)
    assert torch.equal(out, last)
    dlast = (torch.randn(300, 64, generator=gen) * 0.1).to(torch.bfloat16)
    return args, (last, hs, cs), (*args, hs, cs, dlast)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
    assert "needs a GPU" in res.stderr


def test_residual_checks_pass_plain_and_fail_planted_faults(smoke, lstm_case, capsys):
    fwd_args, got, _ = lstm_case
    # both passes of the training step: the same case twice
    smoke.check_lstm_residuals(torch, [(fwd_args, got), (fwd_args, got)])
    out = capsys.readouterr().out
    assert out.count("planted fault") == 2


def test_backward_faults_fail_the_share_rule(smoke, lstm_case, capsys):
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    _, _, bwd_args = lstm_case
    kernel_out = lk.lstm_last_backward(*bwd_args)
    ok, _, err = smoke.backward_agreement(torch, bwd_args, kernel_out, lk.lstm_last_backward_plain(*bwd_args))
    assert ok and err == 0.0
    smoke.check_backward_faults(torch, bwd_args, kernel_out)
    out = capsys.readouterr().out
    assert out.count("planted fault") == 4
    assert lk._bwd_cell.__name__ == "_bwd_cell"  # the patch is undone
