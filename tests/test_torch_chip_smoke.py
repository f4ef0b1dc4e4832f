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


@pytest.fixture(scope="module")
def scan_case(smoke):
    """Two recurrence passes at d=64 as the unfused training step hands them
    to kernels 7 and 8: the forward's inputs and outputs (entity pass, then
    relation pass), and the backward's inputs (relation pass first)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    gen = torch.Generator().manual_seed(1)
    fwd = []
    for B in (300, 120):
        args = smoke.scan_inputs(torch, gen, 10, B, 64)
        fwd.append((args, sk.lstm_scan_forward(*args)))
    bwd = [(*args, *out, (torch.randn(*out[0].shape, generator=gen) * 0.1).to(torch.bfloat16))
           for args, out in reversed(fwd)]
    return fwd, bwd


def test_scan_checks_pass_plain_and_fail_planted_faults(smoke, scan_case, capsys):
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    fwd_err, bwd_err = smoke.check_scan(torch, *scan_case, ragged=(1, 37))
    assert fwd_err == bwd_err == 0.0
    out = capsys.readouterr().out
    assert out.count("planted fault") == 4
    assert lk._bwd_cell.__name__ == "_bwd_cell"  # the patch is undone


def test_every_state_checks_pass_plain_and_fail_planted_faults(smoke, lstm_case, capsys):
    fwd_args, _, _ = lstm_case
    fwd_err, bwd_err = smoke.check_every_state(torch, fwd_args, ragged=(1, 37))
    assert fwd_err == bwd_err == 0.0
    out = capsys.readouterr().out
    assert out.count("planted fault") == 2


def test_kernel_rows_cover_every_tpu_kernel(smoke):
    """One launch counter for each of the eight TPU kernels, and the bounds
    of rows 5-8 at the entity pass's shape (L=10, B=5632, D=H=512, 26,636
    active row-steps) as PERF.md states them."""
    assert len(smoke.kernel_counters()) == 8
    bounds = [smoke.bound_ms(*smoke.lstm_bound(row, 10, 5632, 512, 512, 26636))[0] for row in (5, 6, 7, 8)]
    np.testing.assert_allclose(bounds, [0.1010, 0.3031, 0.1075, 0.2150], atol=6e-5)


# ---------------------------------------------------------------- the f32 modes


@pytest.fixture(scope="module")
def f32_case(smoke):
    """The ragged d=64 pass of ``lstm_case`` in f32: the forward's inputs and
    outputs with residuals, and the backward's inputs."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    gen = torch.Generator().manual_seed(0)
    lens = smoke.synth_lengths(np.random.default_rng(0), 300)
    emb, w_ih, w_hh, bias, lens_t, _ = smoke.lstm_inputs(torch, gen, 10, 300, 64, 64, lens, torch.float32)
    args = (emb, w_ih, w_hh, bias, lens_t)
    last, hs, cs = lk._forward(*args, residuals=True)
    assert hs.dtype == torch.float32
    dlast = torch.randn(300, 64, generator=gen) * 0.1
    return args, (last, hs, cs), (*args, hs, cs, dlast)


def test_f32_residual_checks_fail_planted_faults(smoke, f32_case, capsys):
    """Kernel 1's f32 check: hs one step late, the TF32 yardstick and a
    dropped bias must fail the f32 rule."""
    fwd_args, got, _ = f32_case
    smoke.check_lstm_residuals(torch, [(fwd_args, got), (fwd_args, got)])
    out = capsys.readouterr().out
    assert out.count("planted fault") == 3 and "TF32 operands" in out and "bias dropped" in out


def test_f32_backward_faults_fail_the_rule(smoke, f32_case, capsys):
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    _, _, bwd_args = f32_case
    kernel_out = lk.lstm_last_backward(*bwd_args)
    ok, _, err = smoke.backward_agreement(torch, bwd_args, kernel_out, lk.lstm_last_backward_plain(*bwd_args))
    assert ok and err == 0.0
    smoke.check_backward_faults(torch, bwd_args, kernel_out)
    out = capsys.readouterr().out
    assert out.count("planted fault") == 4 and "TF32 operands" in out and "c_t read in f32" not in out


def test_f32_scan_checks_fail_planted_faults(smoke, capsys):
    """Kernels 7 and 8 in f32: the bf16 faults that still apply, the TF32
    yardstick both ways and a dropped recurrent product."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    gen = torch.Generator().manual_seed(1)
    fwd = []
    for B in (300, 120):
        args = smoke.scan_inputs(torch, gen, 10, B, 64, torch.float32)
        fwd.append((args, sk.lstm_scan_forward(*args)))
    bwd = [(*args, *out, torch.randn(*out[0].shape, generator=gen) * 0.1) for args, out in reversed(fwd)]
    fwd_err, bwd_err = smoke.check_scan(torch, fwd, bwd, ragged=(1, 37))
    assert fwd_err == bwd_err == 0.0
    out = capsys.readouterr().out
    assert out.count("planted fault") == 6 and out.count("TF32 operands") == 2


def test_f32_every_state_checks_fail_planted_faults(smoke, f32_case, capsys):
    """Kernels 5 and 6 in f32: hs one step late, the cotangent at the last
    step only, the TF32 yardstick and a dropped bias each, and kernel 6's
    1xTF32 variant (emulated here, where there is no kernel)."""
    fwd_args, _, _ = f32_case
    fwd_err, bwd_err = smoke.check_every_state(torch, fwd_args, ragged=(1, 37))
    assert fwd_err == bwd_err == 0.0
    out = capsys.readouterr().out
    assert out.count("planted fault") == 7 and out.count("TF32 operands") == 2
    assert "planted fault 1xTF32 variant of lstm_all_bwd_f32" in out


def test_f32_1xtf32_variant_check_fails_the_variant(smoke, f32_case, capsys):
    """Kernel 2's 1xTF32 check on the CPU (the emulated variant) passes,
    that is the variant fails the f32 rule, and it restores torch.matmul."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    _, _, bwd_args = f32_case
    matmul = torch.matmul
    smoke.check_1xtf32_variant(torch, bwd_args, False, lk.lstm_last_backward_plain(*bwd_args))
    assert torch.matmul is matmul
    assert "planted fault 1xTF32 variant of lstm_last_bwd_f32" in capsys.readouterr().out


def test_kernel_rows_list_the_f32_modes(smoke):
    """The kernels line lists the f32 mode of kernels 1, 2 and 5-8 beside the
    eight ports, each with a launch counter; every CUDA source is built; the
    f32 bounds take 4-byte elements at the 3xTF32 rate."""
    counters = smoke.kernel_counters()
    f32_rows = [r for r in smoke.KERNEL_ROWS if r.endswith("_f32")]
    assert len(smoke.KERNEL_ROWS) == 14 and smoke.KERNEL_ROWS[:8] == list(counters)
    assert sorted(r.removesuffix("_f32") for r in f32_rows) == sorted(n for n in counters if n.startswith("lstm_"))
    csrc = ROOT / "open_knowledge_graph_embeddings_tpu_torch" / "csrc"
    assert sorted(smoke.CUDA_SOURCES) == sorted(p.name for p in csrc.glob("*.cu"))
    ops2, bytes2 = smoke.lstm_bound(7, 10, 5632, 512, 512, 56320)
    ops4, bytes4 = smoke.lstm_bound(7, 10, 5632, 512, 512, 56320, es=4)
    assert ops4 == ops2 and bytes4 == 2 * bytes2
    assert smoke.peak_flops(torch.float32) == smoke.PEAK_3XTF32_FLOPS == smoke.PEAK_BF16_FLOPS / 6
    assert smoke.peak_flops(torch.bfloat16) == smoke.PEAK_BF16_FLOPS


def test_f32_backward_launches_and_bound_parts(smoke, monkeypatch):
    """Kernels 2 and 6 launch 2L + 2 times a call at f32 (the weight split
    besides the bf16 kernel's 2L + 1); their work is three equal parts (gate
    recompute, dh/demb, dW), on the entity pass 2.9972e11 FLOP in all: 1.818
    ms at the 3xTF32 rate, 0.606 ms a part, and 4.4796 ms at the FFMA rate
    (132 SMs at 1980 MHz), which the f32 rows print beside it."""
    assert smoke.backward_launches(10, "float32") == smoke.backward_launches(10, torch.float32) == 22
    assert smoke.backward_launches(10, "bfloat16") == smoke.backward_launches(10, torch.bfloat16) == 21
    parts = smoke.backward_parts(5632, 512, 512, 26636)
    assert list(parts) == ["gate", "product", "dW"] and len(set(parts.values())) == 1
    np.testing.assert_allclose(sum(parts.values()), 2.9972e11, rtol=1e-4)
    whole, by = smoke.bound_ms(sum(parts.values()), 0, smoke.peak_flops(torch.float32))
    np.testing.assert_allclose([whole, parts["gate"] / smoke.PEAK_3XTF32_FLOPS * 1e3], [1.818, 0.606], atol=6e-4)
    assert by == "operations"
    monkeypatch.setattr(smoke, "PEAK_FP32_FLOPS", 132 * 128 * 2 * 1980e6)
    assert smoke.ffma_note(sum(parts.values()), torch.float32) == "; FFMA bound 4.4796 ms"
    assert smoke.ffma_note(sum(parts.values()), torch.bfloat16) == ""
