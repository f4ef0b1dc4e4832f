"""chip_smoke.py on the CPU: it refuses to run without a card, and its LSTM
checks have power.  Without a card the wrappers take the plain versions, so
"kernel" and plain version agree exactly; every fault the script plants must
still fail its rule (at d=64 here; the script plants them at the training
shapes on the card)."""

import contextlib
import json
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
    active row-steps) as PERF.md states them, at an H100 SXM's peaks (132
    SMs at 1980 MHz)."""
    assert len(smoke.kernel_counters()) == 8
    bounds = [smoke.bound_ms(*smoke.lstm_bound(row, 10, 5632, 512, 512, 26636))[0] for row in (5, 6, 7, 8)]
    np.testing.assert_allclose(bounds, [0.0933, 0.2800, 0.1039, 0.1986], atol=6e-5)


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
    """Kernel 1's f32 check: hs one step late, the TF32 yardstick, a
    dropped bias and the kernel's 1xTF32 variant (emulated here, where there
    is no kernel) must fail the f32 rule."""
    fwd_args, got, _ = f32_case
    smoke.check_lstm_residuals(torch, [(fwd_args, got), (fwd_args, got)])
    out = capsys.readouterr().out
    assert out.count("planted fault") == 4 and "TF32 operands" in out and "bias dropped" in out
    assert "planted fault 1xTF32 variant of lstm_last_fwd_f32 with residuals" in out


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
    step only, the TF32 yardstick and a dropped bias each, and the 1xTF32
    variants of kernels 5 and 6 (emulated here, where there is no kernel)."""
    fwd_args, _, _ = f32_case
    fwd_err, bwd_err = smoke.check_every_state(torch, fwd_args, ragged=(1, 37))
    assert fwd_err == bwd_err == 0.0
    out = capsys.readouterr().out
    assert out.count("planted fault") == 8 and out.count("TF32 operands") == 2
    assert "planted fault 1xTF32 variant of lstm_all_bwd_f32" in out
    assert "planted fault 1xTF32 variant of lstm_all_fwd_f32" in out


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
    # the tensor cores' peak from SMs x clock: NVIDIA's published 989 TFLOP/s is 132 SMs at 1830 MHz
    np.testing.assert_allclose(smoke.card_peaks(132, 1830)[0], 989e12, rtol=1e-3)
    np.testing.assert_allclose(smoke.card_peaks(132, 1980)[2], 67e12, rtol=2e-3)


def test_forward_launches_and_the_f32_paths_expected_counts(smoke):
    """Kernels 1 and 5 launch L times a call at bf16 and L + 1 at f32 (the
    weight split before the steps), kernels 7 and 8 L and 2L - 1 at bf16,
    L + 1 and 2L at f32 (the split too); the exact counts that train_f32,
    train_unfused_f32, serve_f32 and op_f32 are held to take it: 50 steps of
    two fused passes give 1100 forward launches (1000 at bf16), of two
    unfused passes 1100 kernel 7 and 2000 kernel 8 launches (1000 and 1900
    at bf16), each fused serving encode 11, each unfused one 11 (10 at
    bf16), the op 11 and 22; the Adagrads one dense and one row launch a
    step for the flagship's one regime group, 50 each."""
    assert smoke.forward_launches(10, "bfloat16") == smoke.forward_launches(10, torch.bfloat16) == 10
    assert smoke.forward_launches(10, "float32") == smoke.forward_launches(10, torch.float32) == 11
    assert smoke.scan_launches(10, "bfloat16") == smoke.scan_launches(10, torch.bfloat16) == (10, 19)
    assert smoke.scan_launches(10, "float32") == smoke.scan_launches(10, torch.float32) == (11, 20)
    names = list(smoke.kernel_counters())
    # one regime group: one dense Adagrad and one row update launch a step
    train = smoke.training_launches(names, 10, 50, 50, 50, "float32")
    assert train == {**dict.fromkeys(names, 0), "lstm_last_fwd": 1100, "lstm_last_bwd": 2200,
                     "adagrad_update": 50, "scatter_adagrad": 50}
    assert smoke.training_launches(names, 10, 50, 50, 50, "bfloat16")["lstm_last_fwd"] == 1000
    unfused = smoke.training_launches(names, 10, 50, 50, 50, "float32", unfused=True)
    assert unfused["lstm_last_fwd"] == unfused["lstm_last_bwd"] == 0
    assert (unfused["lstm_scan_fwd"], unfused["lstm_scan_bwd"]) == (1100, 2000)
    unfused16 = smoke.training_launches(names, 10, 50, 50, 50, "bfloat16", unfused=True)
    assert (unfused16["lstm_scan_fwd"], unfused16["lstm_scan_bwd"]) == (1000, 1900)
    serve = smoke.serving_launches(names, 10, 196, 48, "float32")
    assert serve == {**dict.fromkeys(names, 0), "lstm_last_fwd": 196 * 11, "lstm_scan_fwd": 528}
    assert smoke.serving_launches(names, 10, 196, 48, "bfloat16")["lstm_last_fwd"] == 1960
    assert smoke.serving_launches(names, 10, 0, 244, "bfloat16")["lstm_scan_fwd"] == 2440
    assert smoke.op_launches(names, 10, torch.float32) == {**dict.fromkeys(names, 0), "lstm_all_fwd": 11,
                                                           "lstm_all_bwd": 22}
    assert smoke.op_launches(names, 10, torch.bfloat16)["lstm_all_fwd"] == 10


def test_trained_forward_check_holds_the_kernel_to_f64(smoke, f32_case, capsys):
    """The check on a trained checkpoint records the one fused forward of an
    entity encode and holds its output to the same recurrence in f64 (here,
    without a kernel, the plain version: f32 products, within the f32 rule
    of f64); the f64 recurrence is the plain version's arithmetic."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import f32_agreement

    fwd_args, (last, _, _), _ = f32_case
    exact = smoke.plain_last_f64(torch, *fwd_args)
    assert exact.dtype == torch.float64 and f32_agreement(last.double(), exact).rel_err < 1e-6

    class Embedder:
        def encode_entity(self, variables, ids):
            return lk.lstm_encode_last_fused(*fwd_args)[ids]

    model = type("Model", (), {"embedder": Embedder()})()
    recorded = smoke.check_trained_forward(torch, model, {}, torch.arange(8))
    out = capsys.readouterr().out
    assert "trained checkpoint's entity encode (8 ids), kernel vs f64" in out
    assert len(recorded) == 5 and all(torch.equal(a, b) for a, b in zip(recorded, fwd_args))


def test_trained_backward_check_holds_the_kernel_to_f64(smoke, f32_case, capsys):
    """The backward's check on trained weights: the f64 backward is the plain
    version's arithmetic (within the f32 rule of it at every output), the
    kernel (here the plain version) passes, and the 1xTF32 variant (emulated)
    fails it."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import f32_agreement

    fwd_args, _, bwd_args = f32_case
    exact = smoke.plain_last_backward_f64(torch, *bwd_args)
    plain = lk.lstm_last_backward_plain(*bwd_args)
    act = smoke.active_mask(torch, fwd_args)
    assert all(e.dtype == torch.float64 for e in exact)
    assert f32_agreement(plain[0][act], exact[0][act]).rel_err < 1e-6
    assert all(f32_agreement(p, e).rel_err < 1e-6 for p, e in zip(plain[1:], exact[1:]))
    smoke.check_trained_backward(torch, fwd_args)
    out = capsys.readouterr().out
    assert "lstm_last_bwd_f32 on the trained checkpoint's entity encode (300 ids)" in out
    assert "planted fault 1xTF32 variant of lstm_last_bwd_f32 on trained weights" in out and "; fails" in out


def test_f32_backward_launches_and_bound_parts(smoke, monkeypatch):
    """Kernels 2 and 6 launch 2L + 2 times a call at f32 (the weight split
    besides the bf16 kernel's 2L + 1); their work is three equal parts (gate
    recompute, dh/demb, dW), on the entity pass 2.9972e11 FLOP in all, at
    132 SMs and 1980 MHz: 1.680 ms at the 3xTF32 rate, 0.560 ms a part, and
    4.4796 ms at the FFMA rate, which the f32 rows print beside it."""
    assert smoke.backward_launches(10, "float32") == smoke.backward_launches(10, torch.float32) == 22
    assert smoke.backward_launches(10, "bfloat16") == smoke.backward_launches(10, torch.bfloat16) == 21
    parts = smoke.backward_parts(5632, 512, 512, 26636)
    assert list(parts) == ["gate", "product", "dW"] and len(set(parts.values())) == 1
    np.testing.assert_allclose(sum(parts.values()), 2.9972e11, rtol=1e-4)
    whole, by = smoke.bound_ms(sum(parts.values()), 0, smoke.peak_flops(torch.float32))
    np.testing.assert_allclose([whole, parts["gate"] / smoke.PEAK_3XTF32_FLOPS * 1e3], [1.680, 0.560], atol=6e-4)
    assert by == "operations"
    monkeypatch.setattr(smoke, "PEAK_FP32_FLOPS", 132 * 128 * 2 * 1980e6)
    assert smoke.ffma_note(sum(parts.values()), torch.float32) == "; FFMA bound 4.4796 ms"
    assert smoke.ffma_note(sum(parts.values()), torch.bfloat16) == ""


class _FakeProfile:
    """torch.profiler.profile on the CPU: one call's device times (µs, over
    the five profiled calls) of the bf16 backward's kernels by name, as the
    card's trace names them."""

    def __init__(self, activities=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        from types import SimpleNamespace

        # (µs, launches): L = 10 gate and product launches a call, one dW
        names = {"void (anonymous namespace)::bf16::lstm_bwd_gate_kernel_bf16<0>(...)": (1500.0, 50),
                 "(anonymous namespace)::bf16::lstm_bwd_product_kernel_bf16(...)": (1000.0, 50),
                 "void (anonymous namespace)::bf16::lstm_bwd_dw_kernel_bf16<0>(...)": (2000.0, 5),
                 "void at::native::vectorized_elementwise_kernel<...>": (50.0, 5)}
        return [SimpleNamespace(key=k, self_device_time_total=v, count=n) for k, (v, n) in names.items()]


def test_bf16_backward_launch_split_prints_each_part_beside_its_bound(smoke, lstm_case, monkeypatch, capsys):
    """The bf16 backward's launches by kind (gate, product, dW: names read
    from the profiler's trace, other kernels left out), device ms per call,
    each beside the bound of its part at the bf16 peak; the parts of a
    backward are the forward's work each."""
    import torch.profiler

    _, _, bwd_args = lstm_case
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    by_kind = smoke.print_backward_launch_ms(torch, "lstm_last_bwd", bwd_args, lambda: None)
    assert by_kind == pytest.approx({"gate": 0.3, "product": 0.2, "dW": 0.4})
    n_steps = int(bwd_args[4].clamp(min=1).sum())
    part = smoke.backward_parts(300, 64, 64, n_steps)["gate"] / smoke.PEAK_BF16_FLOPS * 1e3
    out = capsys.readouterr().out
    assert out.startswith("lstm_last_bwd launches on the entity pass B=300, device ms per call (torch.profiler): ")
    assert f"gate 0.3000 (bf16 bound of its part {part:.4f}, {part / 0.3:.1%} of it)" in out
    assert f"product 0.2000 (bf16 bound of its part {part:.4f}" in out and "; sum 0.9000" in out
    assert "split" not in out
    assert set(smoke.BACKWARD_BF16_KINDS) == {"gate", "product", "dW"}


def test_gates_bitwise_check_fails_a_one_ulp_difference(smoke, lstm_case, capsys):
    """The gates phase holds kernel 1's and the backward's stores of the f32
    pre-activation gates to bitwise equality at the positions each row
    reaches: a one-ulp difference there fails it, one at a position no row
    reaches does not count."""
    fwd_args, _, _ = lstm_case
    lens = fwd_args[4]
    gates = torch.from_numpy(np.random.default_rng(3).standard_normal((10, 300, 256)).astype(np.float32))
    smoke.check_gates_bitwise(torch, "equal", fwd_args, stored=(gates, gates.clone()))
    assert "equal: 0 of " in capsys.readouterr().out
    step = int(lens.clamp(min=1)[-1]) - 1  # the last step of the shortest row
    planted = gates.clone()
    planted[step, -1, 7] = torch.nextafter(planted[step, -1, 7], torch.tensor(np.inf))
    with pytest.raises(smoke.SmokeFailure, match="1 unequal"):
        smoke.check_gates_bitwise(torch, "planted", fwd_args, stored=(gates, planted))
    unread = gates.clone()
    unread[step + 1, -1, 7] += 1.0  # past the shortest row's length: never written
    smoke.check_gates_bitwise(torch, "unread", fwd_args, stored=(gates, unread))


def test_scan_gates_bitwise_check_fails_a_one_ulp_difference(smoke, capsys):
    """The kernel 7/8 gates phase holds kernel 7's and kernel 8's stores of
    the f32 pre-activation gates to bitwise equality at every (row, step):
    a one-ulp difference anywhere fails it, and so does a store of zeros
    (the launches stored nothing)."""
    gates = torch.from_numpy(np.random.default_rng(4).standard_normal((10, 37, 256)).astype(np.float32))
    smoke.check_scan_gates_bitwise(torch, "equal", None, None, stored=(gates, gates.clone()))
    assert "kernel 7 vs kernel 8's gate launch, equal: 0 of 94720 " in capsys.readouterr().out
    for t, row in ((0, 0), (9, 36)):
        planted = gates.clone()
        planted[t, row, 255] = torch.nextafter(planted[t, row, 255], torch.tensor(np.inf))
        with pytest.raises(smoke.SmokeFailure, match="1 unequal"):
            smoke.check_scan_gates_bitwise(torch, "planted", None, None, stored=(gates, planted))
    zeros = torch.zeros_like(gates)
    with pytest.raises(smoke.SmokeFailure, match="all zero"):
        smoke.check_scan_gates_bitwise(torch, "zeros", None, None, stored=(zeros, zeros.clone()))


class _FakeScanProfile(_FakeProfile):
    """The same for kernel 8 in bf16: its gate and product launches."""

    def key_averages(self):
        from types import SimpleNamespace

        names = {"void (anonymous namespace)::bf16::lstm_scan_bwd_gate_kernel_bf16<0>(...)": 1500.0,
                 "(anonymous namespace)::bf16::lstm_scan_bwd_product_kernel_bf16(...)": 1000.0,
                 "void at::native::vectorized_elementwise_kernel<...>": 50.0}
        return [SimpleNamespace(key=k, self_device_time_total=v) for k, v in names.items()]


def test_scan_backward_launch_split_prints_each_part_beside_its_bound(smoke, scan_case, monkeypatch, capsys):
    """Kernel 8's launches by kind (gate, product: names read from the
    profiler's trace, other kernels left out), device ms per call, each
    beside the bound of its part; on the unfused entity pass (L=10, B=5632,
    H=512, bf16) the gate launches are bound by their bytes (x_proj, hs, cs
    and dhs in, dx_proj out: 0.1900 ms) and the product launches by their
    operations (0.0993 ms, as the gate launches' products), at an H100
    SXM's peaks (132 SMs at 1980 MHz)."""
    import torch.profiler

    _, bwd = scan_case
    monkeypatch.setattr(torch.profiler, "profile", _FakeScanProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    by_kind = smoke.print_scan_backward_launch_ms(torch, "lstm_scan_bwd", bwd[1], lambda: None)
    assert by_kind == pytest.approx({"gate": 0.3, "product": 0.2})
    out = capsys.readouterr().out
    assert out.startswith("lstm_scan_bwd launches, device ms per call (torch.profiler): gate 0.3000 (bound of its "
                          "part ") and "product 0.2000 (bound of its part " in out and "; sum 0.5000" in out
    assert set(smoke.SCAN_BACKWARD_KINDS) == {"gate", "product"}
    parts = smoke.scan_backward_parts(10, 5632, 512, 2)
    gate, product = (smoke.bound_ms(*parts[k]) for k in ("gate", "product"))
    np.testing.assert_allclose([gate[0], product[0]], [0.1900, 0.0993], atol=6e-5)
    assert (gate[1], product[1]) == ("bytes", "operations")


def _f32_scan_pass(smoke, B=120, H=64, seed=2):
    gen = torch.Generator().manual_seed(seed)
    return smoke.scan_inputs(torch, gen, 10, B, H, torch.float32)


def test_f32_scan_gates_bitwise_check_fails_a_one_ulp_difference(smoke, capsys):
    """The f32 kernel 7/8 gates phase holds the two stores bitwise at every
    (row, step), as in bf16: equal stores pass, a one-ulp difference fails;
    on the CPU (where the phase has no kernel to launch) the entity pass and
    B=37 are labelled f32."""
    gates = torch.from_numpy(np.random.default_rng(5).standard_normal((10, 120, 256)).astype(np.float32))
    smoke.check_scan_gates_bitwise(torch, "f32 equal", None, None, stored=(gates, gates.clone()))
    assert "kernel 7 vs kernel 8's gate launch, f32 equal: 0 of 307200 " in capsys.readouterr().out
    planted = gates.clone()
    planted[4, 60, 100] = torch.nextafter(planted[4, 60, 100], torch.tensor(-np.inf))
    with pytest.raises(smoke.SmokeFailure, match="1 unequal"):
        smoke.check_scan_gates_bitwise(torch, "f32 planted", None, None, stored=(gates, planted))
    labels = []
    real = smoke.check_scan_gates_bitwise
    smoke.check_scan_gates_bitwise = lambda torch, label, x_proj, w_hh: labels.append((label, x_proj.dtype))
    try:
        smoke.check_scan_gates(torch, _f32_scan_pass(smoke))
    finally:
        smoke.check_scan_gates_bitwise = real
    assert labels == [("f32 unfused training entity pass B=120", torch.float32), ("f32 B=37", torch.float32)]


def test_f32_scan_1xtf32_variant_check_fails_the_variant(smoke, capsys):
    """Kernels 7 and 8's 1xTF32 check on the CPU: the emulated variant (one
    TF32 product per product), run as the unfused LSTM runs the pair (the
    backward on the variant forward's residuals and a last-state cotangent,
    as the unfused training step sends it), fails the f32 rule, so the check
    passes; torch.matmul is restored.  Where the variant passes the rule,
    the check fails."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj, w_hh = _f32_scan_pass(smoke)
    hs, cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    dhs = torch.zeros_like(hs)
    dhs[-1] = torch.randn(*hs.shape[1:], generator=torch.Generator().manual_seed(6))
    matmul = torch.matmul
    smoke.check_scan_1xtf32_variant(torch, (x_proj, w_hh), (x_proj, w_hh, hs, cs, dhs))
    assert torch.matmul is matmul
    real = smoke.one_tf32_product
    smoke.one_tf32_product = lambda torch: contextlib.nullcontext()  # the "variant" is the plain version
    try:
        with pytest.raises(smoke.SmokeFailure, match="passes the 1xTF32 variant of kernels 7 and 8"):
            smoke.check_scan_1xtf32_variant(torch, (x_proj, w_hh), (x_proj, w_hh, hs, cs, dhs))
    finally:
        smoke.one_tf32_product = real
    assert torch.matmul is matmul
    out = capsys.readouterr().out
    assert "planted fault 1xTF32 variant of lstm_scan_fwd_f32 + lstm_scan_bwd_f32 B=120: hs " in out
    assert "planted fault 1xTF32 variant of lstm_scan_bwd_f32 alone B=120" in out


def test_trained_scan_check_holds_kernels_7_and_8_to_f64(smoke, capsys):
    """The f64 recurrence, its single steps and its backward are the plain
    versions' arithmetic (within the f32 rule of them); the trained-weights
    check passes the plain f32 versions (the kernels here), fails the
    emulated 1xTF32 variant, and its rule (f32 rule against f64, or twice
    the plain version's error) fails a planted fault."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk
    from open_knowledge_graph_embeddings_tpu_torch.utils.numerics import f32_agreement

    x_proj, w_hh = _f32_scan_pass(smoke)
    hs, cs = sk.lstm_scan_forward_plain(x_proj, w_hh)
    exact_hs, exact_cs = smoke.plain_scan_f64(torch, x_proj, w_hh)
    dhs = torch.randn(*hs.shape, generator=torch.Generator().manual_seed(3)) * 0.1
    exact_dxp = smoke.plain_scan_backward_f64(torch, x_proj, w_hh, hs, cs, dhs)
    assert exact_hs.dtype == exact_dxp.dtype == torch.float64
    for got, exact in ((hs, exact_hs), (cs, exact_cs), (sk.lstm_scan_backward_plain(x_proj, w_hh, hs, cs, dhs),
                                                         exact_dxp)):
        assert f32_agreement(got, exact).rel_err < 1e-6
    lens = torch.from_numpy(smoke.synth_lengths(np.random.default_rng(4), 120))
    smoke.check_trained_scan(torch, x_proj, w_hh, lens)
    out = capsys.readouterr().out
    reached = int(lens.clamp(min=1).sum())
    assert f"on the trained unfused checkpoint's entity encode (120 ids, {reached} reached positions)" in out
    assert "measured the whole trained recurrence vs f64" in out
    # one step alone from a run's own state: in f64 the exact step, in f32 the plain version's arithmetic
    step_hs, step_cs = smoke.scan_steps(torch, x_proj, w_hh, hs, cs, torch.float32)
    assert torch.allclose(step_hs, hs, rtol=0, atol=1e-6) and torch.allclose(step_cs, cs, rtol=0, atol=1e-6)
    exact_step = smoke.scan_steps(torch, x_proj, w_hh, hs, cs, torch.float64)
    assert exact_step[0].dtype == torch.float64 and f32_agreement(hs, exact_step[0]).rel_err < 1e-6
    assert "planted fault 1xTF32 variant of lstm_scan_fwd_f32 / lstm_scan_bwd_f32 on trained weights" in out
    assert "; fails" in out
    exact = (exact_hs, exact_cs)
    yard = [f32_agreement(x.double(), e) for x, e in zip((hs, cs), exact)]
    assert smoke.f64_agreement(torch, (hs, cs), exact, yard)[0]
    planted = (hs, cs * (1 + 1e-4))  # c off by 1e-4 of itself
    ok, agree = smoke.f64_agreement(torch, planted, exact, yard)
    assert not ok and agree[0].ok() and not agree[1].ok()


class _FakeScanF32Profile(_FakeProfile):
    """The same for kernels 7 and 8 at f32: the weight split, kernel 7's
    steps, kernel 8's gate and product launches."""

    def key_averages(self):
        from types import SimpleNamespace

        names = {"void oket_tf32::lstm_split_kernel_tf32<true>(...)": 100.0,
                 "void (anonymous namespace)::tf32::lstm_scan_step_kernel_tf32<0, false>(...)": 2000.0,
                 "void (anonymous namespace)::tf32::lstm_scan_bwd_gate_kernel_tf32<0, false>(...)": 1500.0,
                 "void (anonymous namespace)::tf32::lstm_scan_bwd_product_kernel_tf32<0>(...)": 1000.0}
        return [SimpleNamespace(key=k, self_device_time_total=v) for k, v in names.items()]


def test_f32_scan_launch_splits_print_each_kind_beside_its_bound(smoke, monkeypatch, capsys):
    """At f32 kernel 8's launches by kind are the split, gate and product
    (the split bound by its bytes: W_hh read, four parts written), and
    kernel 7's split apart from its steps, each beside its bound."""
    import torch.profiler

    x_proj, w_hh = _f32_scan_pass(smoke)
    hs, cs = (x.contiguous() for x in (x_proj[..., :64], x_proj[..., 64:128]))
    monkeypatch.setattr(torch.profiler, "profile", _FakeScanF32Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    by_kind = smoke.print_scan_backward_launch_ms(torch, "lstm_scan_bwd_f32", (x_proj, w_hh, hs, cs, hs),
                                                  lambda: None)
    assert by_kind == pytest.approx({"split": 0.02, "gate": 0.3, "product": 0.2})
    out = capsys.readouterr().out
    assert out.startswith("lstm_scan_bwd_f32 launches, device ms per call (torch.profiler): split 0.0200 (bound "
                          "of its part ") and "; sum 0.5200" in out
    split_ops, split_bytes = smoke.scan_backward_parts(10, 120, 64, 4)["split"]
    assert split_ops == 0 and split_bytes == 5 * 4 * 64 * 64 * 4
    assert "split" not in smoke.scan_backward_parts(10, 120, 64, 2)
    smoke.print_scan_forward_launch_ms(torch, "lstm_scan_fwd_f32", x_proj, w_hh, lambda: None)
    out = capsys.readouterr().out
    assert out.startswith("lstm_scan_fwd_f32 launches, device ms per call (torch.profiler): split 0.0200 (bytes "
                          "bound ") and "steps 0.4000 (bound " in out and "; sum 0.4200" in out


# ---------------------------------------------------------------- the Adagrads


@pytest.mark.parametrize("kind", ["dense", "rows"])
def test_adagrad_checks_pass_plain_and_fail_planted_faults(smoke, kind, capsys):
    """The Adagrads' bitwise check on the ragged cases (here the wrappers take
    the plain twins): it passes, every planted fault fails it, and a
    "kernel" that takes the learning rate as a reciprocal and a product
    fails the run."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel as ak
    from open_knowledge_graph_embeddings_tpu_torch.ops import scatter_adagrad_kernel as sk

    if kind == "dense":
        name, case = "adagrad_update", smoke.ragged_dense_group(torch, [300, 100], device="cpu")
        kernel, plain, faults = ak.adagrad_update_leaves, ak.adagrad_update_leaves_plain, smoke.dense_faults(ak)
    else:
        name, case = "scatter_adagrad", smoke.ragged_row_tables(torch, device="cpu")
        kernel, plain, faults = sk.scatter_adagrad_tables, sk.scatter_adagrad_tables_plain, smoke.padding_writer(sk)
    assert smoke.check_adagrad_cases(torch, name, [("ragged", case, True)], kernel, plain, faults) == 0.0
    out = capsys.readouterr().out
    assert out.count("fails the bitwise check") == len(faults) == 2
    assert "learning rate as lr / tensor" in faults

    def reciprocal_kernel(*args):
        faults["learning rate as lr / tensor"](*args)
        return [s + 1.0 for s in args[-2]]

    with pytest.raises(smoke.SmokeFailure, match="not bit-equal"):
        smoke.check_adagrad_cases(torch, name, [("ragged", case, False)], reciprocal_kernel, plain, faults)


def test_family_kernel_check_holds_every_recorded_launch(smoke, lstm_case, scan_case, capsys):
    """``check_family_kernels`` on a record of every training kernel (here
    the wrappers take the plain versions): each is held and reported under
    its kernel row; a planted fault in a recorded forward fails the run, and
    so does a kernel that launched with no record."""
    from types import SimpleNamespace

    fwd_args, got, bwd_args = lstm_case
    capture = SimpleNamespace(fwd=[(fwd_args, got)], bwd=[bwd_args], scan_fwd=scan_case[0], scan_bwd=scan_case[1],
                              dense=smoke.ragged_dense_group(torch, [300, 100], device="cpu"),
                              rows=smoke.ragged_row_tables(torch, device="cpu"))
    launches = {name: 1 for name in smoke.FAMILY_RECORDS.values()}
    errs = smoke.check_family_kernels(torch, "case", capture, launches)
    assert errs == {name: 0.0 for name in smoke.FAMILY_RECORDS.values()}
    out = capsys.readouterr().out
    assert out.count("case lstm_scan_fwd pass") == 2 and out.count("bit-equal True") == 2

    last, hs, cs = got
    late = SimpleNamespace(**{**vars(capture), "fwd": [(fwd_args, (last, torch.cat([hs[:1], hs[:-1]]), cs))]})
    with pytest.raises(smoke.SmokeFailure, match="lstm_last_fwd disagrees"):
        smoke.check_family_kernels(torch, "case", late, launches)
    missing = SimpleNamespace(**{**vars(capture), "scan_bwd": []})
    with pytest.raises(smoke.SmokeFailure, match="lstm_scan_bwd launched, but no launch was recorded"):
        smoke.check_family_kernels(torch, "case", missing, launches)


def test_one_row_backward_check_reports_shares_and_f64_errors(smoke, capsys):
    """Kernel 6's one-row check (here on the plain versions, a few draws):
    the test's inputs, a bitwise repeat, demb's unequal share per draw and
    both errors against the f64 backward, which bf16 demb sits within a few
    bf16 ulps of."""
    shares, k_err, p_err = smoke.check_one_row_backward(torch, draws=3, device="cpu")
    out = capsys.readouterr().out
    assert "twice on the same inputs, bitwise equal (demb, dW_ih, dW_hh, db): [True, True, True, True]" in out
    assert "3 cotangent draws" in out and "draw 0, the test's" in out
    assert len(shares) == 3 and not shares.any()
    np.testing.assert_array_equal(k_err, p_err)
    assert 0 < p_err.max() < 4 * 2 ** -8


def test_optimizer_spans_time_each_part_of_a_sparse_step(smoke, toy_dataset_dir):
    """The training step's optimizer clock: a clock around one row-sparse
    step reads both of the script's optimizer spans (the dense leaves'
    ``make_apply`` and update, the row update) inside the step's
    ``train.optimizer``, and after its block reads no more."""
    from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
    from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder, make_sparse_train_step
    from open_knowledge_graph_embeddings_tpu_torch.train.step import arrays_to_device
    from open_knowledge_graph_embeddings_tpu_torch.utils import tracing

    ds = OneToNMentionRelationDataset(dataset_dir=toy_dataset_dir, input_file="train.txt", is_training_data=True,
                                      batch_size=2, use_batch_shared_entities=True, min_size_batch_labels=6,
                                      cache_dir=toy_dataset_dir + "/smoke_optimizer_spans")
    model = build_model("LSTMComplexRelationModel", ds.meta, entity_slot_size=8, sparse=True)
    variables = model.init(torch.Generator().manual_seed(0))
    regimes = OptimizerRegimes({"optimizer": "Adagrad", "lr": 0.2})
    regimes.update(1, 0)
    step = make_sparse_train_step(model, regimes, variables["params"], entity_sparse=True)
    arrays = arrays_to_device(SparsePlanBuilder(model.embedder, True, min_rows_ratio=0.0)(
        next(iter(BatchBuilder(ds, seed=0).batches()))), "cpu")
    assert any(k.startswith("sparse/") for k in arrays)
    opt_state = regimes.init_state(variables["params"])
    with tracing.clock() as clock:
        variables, opt_state, _ = step(variables, opt_state, regimes.hparams(), arrays)
    assert all(clock.ms.get(k, 0.0) > 0 for k in smoke.OPTIMIZER_SPANS), clock.ms
    assert sum(clock.ms[k] for k in smoke.OPTIMIZER_SPANS) <= clock.ms["train.optimizer"]
    read = dict(clock.ms)
    step(variables, opt_state, regimes.hparams(), arrays)
    assert clock.ms == read


@pytest.mark.parametrize("dtype,per_encode", [("bfloat16", 10), ("float32", 11)])
def test_eval_launch_formulas(smoke, dtype, per_encode):
    """At L = 10 an encode is 10 kernel 1 launches in bf16 and 11 at f32:
    the flagship's validation of 16 batches is 2 passes a batch (the 32768
    candidates with the 128 queries, then the relations), its test eval 76
    cache chunks of 32768 rows and 2 passes for each of 8 batches of 256,
    and a training run of 50 steps with two validation evals of 16 batches
    adds their passes to its own."""
    names = list(smoke.kernel_counters())
    assert smoke.eval_launches(names, 10, dtype, val_batches=16) == {
        **dict.fromkeys(names, 0), "lstm_last_fwd": 32 * per_encode}
    assert smoke.eval_launches(names, 10, dtype, cache_chunks=76, test_batches=8)["lstm_last_fwd"] == 92 * per_encode
    train = smoke.training_launches(names, 10, 50, 50, 50, dtype, val_batches=32)
    assert train["lstm_last_fwd"] == (100 + 64) * per_encode
    assert train["lstm_last_bwd"] == 100 * smoke.backward_launches(10, dtype)
    unfused = smoke.training_launches(names, 10, 50, 50, 50, dtype, unfused=True, val_batches=32)
    assert unfused["lstm_last_fwd"] == 64 * per_encode and unfused["lstm_last_bwd"] == 0


def _ranking_case():
    """Three golds over 8 columns (column 7 padding): gold 0 (true 0.5 at
    column 0, filter {0, 1}) has one larger and two tied candidates left,
    gold 1 (true 0.7, the larger of its mentions 1 and 3) none, gold 2 (all
    scores equal, filter {5}) six ties."""
    rows = np.array([[0.5, 0.9, 0.5, 0.2, 0.9, -1.0, 0.5, 0.1],
                     [0.3, 0.3, 0.1, 0.7, 0.3, 0.2, 0.0, 0.9],
                     [0.4] * 8], np.float32)
    mentions = np.array([[0, -1], [1, 3], [5, -1]])
    filt = [np.array([0, 1]), np.array([1, 3]), np.array([5])]
    col_valid = np.arange(8) < 7
    return rows, mentions, filt, col_valid


def test_host_recount_and_its_planted_faults(smoke, capsys):
    rows, mentions, filt, col_valid = _ranking_case()
    got = smoke.host_ranks(rows, mentions, filt, col_valid)
    assert got["ranks"].tolist() == [2, 0, 3]
    assert got["no filter"].tolist() == [3, 0, 3]
    assert got["ties as >"].tolist() == [3, 0, 6]
    ranks = np.array([2, 0, 3])
    assert smoke.check_ranking("case", [(rows, mentions, filt, col_valid, ranks)]) == 3
    assert "0 differ" in capsys.readouterr().out
    for wrong in ([3, 0, 3], [3, 0, 6], [2, 1, 3]):  # the planted faults, one rank off
        with pytest.raises(smoke.SmokeFailure, match="differs from the port"):
            smoke.check_ranking("case", [(rows, mentions, filt, col_valid, np.array(wrong))])
    # a batch on which neither fault shows cannot hold the ranking
    with pytest.raises(smoke.SmokeFailure, match="no power"):
        smoke.check_ranking("case", [(rows[1:2], mentions[1:2], filt[1:2], col_valid, np.array([0]))])
    # a batch without ties: the ties fault is required unless the caller
    # says no ties are expected (random lookup embeddings)
    untied = (np.array([[0.5, 0.9, 0.2, 0.1, 0.0, 0.3, -0.1, 0.0]], np.float32), mentions[:1], filt[:1], col_valid,
              np.array([0]))
    with pytest.raises(smoke.SmokeFailure, match="'ties as >' changes no rank"):
        smoke.check_ranking("case", [untied])
    assert smoke.check_ranking("case", [untied], ties_expected=False) == 1


def test_f64_check_holds_ranks_within_the_f32_bound(smoke, capsys):
    """check_against_f64 on a recorded chunked batch (CPU tensors): the
    port's ranks pass; a rank moved past the candidates near true fails."""
    from open_knowledge_graph_embeddings_tpu_torch.train.evaluate import eval_stats_chunked

    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((6, 32)).astype(np.float32))
    cache = rng.standard_normal((500, 32)).astype(np.float32)
    cache[[9, 400]] = cache[4]  # exact ties with gold 0's and gold 1's mention
    cache = torch.from_numpy(cache)
    golds = (torch.tensor([0, 0, 3, 5], dtype=torch.int32), torch.tensor([4, 7, 4, 100], dtype=torch.int32),
             torch.tensor([0, 3, 5, -1], dtype=torch.int32), torch.tensor([[4, 7], [4, -1], [100, -1], [-1, -1]],
                                                                          dtype=torch.int32))
    pos = (torch.tensor([0], dtype=torch.int32), torch.tensor([4], dtype=torch.int32), torch.ones(6, dtype=torch.bool))
    _, ranks, valid = eval_stats_chunked(q, cache, *pos, None, torch.tensor(500.0), *golds, chunk=128)

    class Cap:
        cache = None
        chunked = []

    cap = Cap()
    cap.cache = cache
    cap.chunked = [{"q": q, "golds": golds, "col_valid": None, "ranks": ranks, "gold_valid": valid}]
    m32, m64 = smoke.check_against_f64(torch, "case", cap)
    assert m32 == m64 and "0 of 3 ranks differ" in capsys.readouterr().out
    bad = ranks.clone()
    bad[2] += 40
    cap.chunked[0]["ranks"] = bad
    with pytest.raises(smoke.SmokeFailure, match="f32 error bound"):
        smoke.check_against_f64(torch, "case", cap)


# ------------------------------------------------- objectives and optimizers


ACCUM_CONFIG = dict(model="LSTMComplexRelationModel", batch_size=2, batch_size_for_backward=4, epochs=2,
                    model_config={"entity_slot_size": 8, "init_std": 0.1, "sparse": True, "dropout": 0.1},
                    optimization_config={"optimizer": "Adagrad", "lr": 0.3}, eval_epoch_freq=0, print_freq=1,
                    sparse_min_ratio=0.0, workers=2, seed=1,
                    train_data_config={"input_file": "train.txt", "batch_size": 2, "use_batch_shared_entities": True,
                                       "min_size_batch_labels": 6})


def _accum_config(tmp_path, toy_dataset_dir, **over):
    import yaml

    path = tmp_path / "accum.yaml"
    path.write_text(yaml.safe_dump({**ACCUM_CONFIG, "dataset_dir": toy_dataset_dir,
                                    "experiment_dir": str(tmp_path / "exp"), **over}))
    return path


@pytest.mark.parametrize("ratio", [0.0, 12.0], ids=["row-sparse", "dense-fallback"])
def test_window_count_matches_a_cli_run(smoke, toy_dataset_dir, tmp_path, ratio):
    """``count_windows`` (the host count made before the card run) against
    the port's ``cli.train`` with accumulation on the toy set: the same
    windows with the same row-sparse tables, an update after each window's
    last micro-batch, and the same carried batches."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import train as port_train

    config = _accum_config(tmp_path, toy_dataset_dir, sparse_min_ratio=ratio)
    windows, carried, per_pass, B, N = smoke.count_windows(config, passes=2, accum=2)
    assert (per_pass, B, N) == (5, 2, 6) and len(windows) == 5 and carried == 0
    assert all(w == (("entity_token_embedding", "relation_token_embedding") if ratio == 0 else ()) for w in windows)
    trainer = port_train.cli_main([str(config), "--device", "cpu"])
    assert [s["sparse_tables"] for s in trainer.step_log] == [w for w in windows for _ in range(2)]
    assert sum(s["applied"] for s in trainer.step_log) == len(windows)
    assert len(trainer._window_buf) == carried and trainer._accum_i == 0



def test_window_tables_carry_the_rest(smoke, toy_dataset_dir):
    """Seven batches in windows of three: two windows, one carried."""
    from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
    from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder

    ds = OneToNMentionRelationDataset(dataset_dir=toy_dataset_dir, input_file="train.txt", is_training_data=True,
                                      batch_size=2, use_batch_shared_entities=True, min_size_batch_labels=6,
                                      cache_dir=toy_dataset_dir + "/smoke_windows")
    model = build_model("LookupComplexRelationModel", ds.meta, entity_slot_size=8, sparse=True)
    plan = SparsePlanBuilder(model.embedder, True, min_rows_ratio=0.0)
    builder = BatchBuilder(ds, seed=0)
    batches = list(builder.batches(shuffle=True)) + list(builder.batches(shuffle=True))[:2]
    windows, carried = smoke.window_tables(plan, batches, 3)
    assert len(windows) == 2 and carried == 1
    assert windows == [("entity_embedding", "relation_embedding")] * 2


def test_scheduler_closed_forms_match_the_port(smoke):
    """The script's own closed forms (StepLR, CosineAnnealingLR) and its
    replay of ReduceLROnPlateau equal the port's scheduler, epoch by epoch
    and eval by eval, and its phase lr the port's merged one."""
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes

    for cfg in ({"lr_scheduler": "StepLR", "step_size": 1, "gamma": 0.5},
                {"lr_scheduler": "StepLR", "step_size": 3, "gamma": 0.3},
                {"lr_scheduler": "CosineAnnealingLR", "T_max": 4, "eta_min": 0.1},
                {"lr_scheduler": "CosineAnnealingLR", "T_max": 9}):
        reg = OptimizerRegimes([[{"optimizer": "Adagrad", "lr": 0.3}, {"step": 5, "optimizer": "Adadelta",
                                                                        "lr": 1.0}]], cfg)
        for epoch in range(12):
            reg.update(1, 1 + 3 * epoch)
            reg.lr_scheduler_step(0.0, epoch=epoch)
            base = smoke.phase_lr(reg.regimes[0], reg.current_phase[0])
            assert reg.lr_scale[0] == smoke.lr_scale(cfg, epoch, base), (cfg, epoch)
            assert reg.hparams()[0]["lr"] == base * reg.lr_scale[0]
    metrics = [0.1, 0.2, 0.2, 0.15, 0.3, 0.29, 0.28, 0.31, 0.31]
    for patience in (0, 1, 2):
        reg = OptimizerRegimes({"optimizer": "Adagrad", "lr": 0.3},
                               {"lr_scheduler": "ReduceLROnPlateau", "factor": 0.5, "patience": patience})
        reg.update(1, 0)
        got = []
        for m in metrics:
            reg.lr_scheduler_step(m, epoch=1)
            got.append(reg.lr_scale[0])
        assert got == smoke.plateau_scales(metrics, 0.5, patience)
    assert smoke.plateau_scales(metrics, 0.5, 0) != [1.0] * len(metrics)


def test_hparam_log_records_each_call_and_restores(smoke):
    from open_knowledge_graph_embeddings_tpu_torch.ops import adagrad_kernel
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes

    orig = (OptimizerRegimes.hparams, adagrad_kernel._launch)
    reg = OptimizerRegimes([{"optimizer": "RMSprop", "lr": 0.1, "match": "r"}, {"optimizer": "Adagrad", "lr": 0.2}])
    reg.update(1, 0)
    with smoke.HparamLog() as log:
        reg.hparams()
        reg.lr_scale = [0.5, 1.0]
        reg.hparams()
    assert (OptimizerRegimes.hparams, adagrad_kernel._launch) == orig
    assert [c[0] for c in log.calls] == [["RMSprop", "Adagrad"]] * 2 and log.calls[1][1] == [0, 0]
    assert [c[2][0]["lr"] for c in log.calls] == [0.1, 0.05] and log.launch_lrs == []


def test_window_gradient_check_holds_the_sum_and_fails_a_missing_micro_batch(smoke, toy_dataset_dir, tmp_path,
                                                                             monkeypatch, lstm_case, capsys):
    """``check_window_gradients`` on a CPU run with accumulation (dropout
    on: the recorded generator states must replay the masks): the first
    window's summed row gradients, as the row update was handed them, pass
    the bf16 rule against its micro-batches recomputed alone on the plain
    path and the f32 rule against them recomputed with the kernels, and the
    sum without one micro-batch fails both; ``repeat_probe`` replays
    micro-batch 0 and a recorded backward twice each."""
    from open_knowledge_graph_embeddings_tpu_torch.cli import train as port_train
    from open_knowledge_graph_embeddings_tpu_torch.train import optim, sparse

    recorded = {}
    orig_rows, orig_dense = sparse.scatter_adagrad_tables, optim.adagrad_update_leaves

    def rows(g_rows, uids, valid, ps, accs, steps, hp):
        recorded.setdefault("rows", ([g.clone() for g in g_rows], uids, valid, [p.clone() for p in ps]))
        return orig_rows(g_rows, uids, valid, ps, accs, steps, hp)

    def dense(gs, ps, accs, steps, hp):
        recorded.setdefault("dense", ([g.clone() for g in gs], [p.clone() for p in ps]))
        return orig_dense(gs, ps, accs, steps, hp)

    monkeypatch.setattr(sparse, "scatter_adagrad_tables", rows)
    monkeypatch.setattr(optim, "adagrad_update_leaves", dense)
    config = _accum_config(tmp_path, toy_dataset_dir)
    with smoke.WindowCapture(2) as wcap:
        trainer = port_train.cli_main([str(config), "--device", "cpu"])
    assert len(wcap.micro) == 2
    err = smoke.check_window_gradients(torch, trainer, wcap, recorded["rows"], recorded["dense"])
    assert err <= 1e-6
    out = capsys.readouterr().out
    assert out.count("planted fault (one micro-batch left out)") == 4
    assert out.count("on the plain path (kernels 1 and 2 off)") == 2
    smoke.repeat_probe(torch, trainer, wcap, lstm_case[2])
    out = capsys.readouterr().out
    assert "(B=300): bit-equal {'demb': True, 'dW_ih': True, 'dW_hh': True, 'db': True}" in out
    assert "micro-batch 0's gradients twice, bit-equal by table {" in out
    assert not torch.are_deterministic_algorithms_enabled()


def test_plain_lstm_swaps_the_launchers_and_restores_them(smoke, lstm_case):
    """Inside ``plain_lstm`` kernels 1 and 2's launchers are the plain
    versions (equal results on the same inputs, no launch counted), and the
    launchers are restored after; ``fold_errs`` keeps each row's largest."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    fwd_args, (last, hs, cs), bwd_args = lstm_case
    orig = lk._launch_forward, lk._launch_backward
    n = lk.lstm_encode_last_fused.launches, lk.lstm_last_backward.launches
    with smoke.plain_lstm():
        assert (lk._launch_forward, lk._launch_backward) != orig
        got = lk._launch_forward(*fwd_args, True)
        assert all(torch.equal(x, y) for x, y in zip(got, (last, hs, cs)))
        assert torch.equal(lk._launch_forward(*fwd_args, False), last)
        for x, y in zip(lk._launch_backward(*bwd_args), lk.lstm_last_backward_plain(*bwd_args)):
            assert torch.equal(x, y)
    assert (lk._launch_forward, lk._launch_backward) == orig
    assert (lk.lstm_encode_last_fused.launches, lk.lstm_last_backward.launches) == n
    assert smoke.fold_errs({"a": 1.0, "b": 0.5}, {"b": 2.0, "c": 0.1}) == {"a": 1.0, "b": 2.0, "c": 0.1}


def test_corpus_generator_is_deterministic(smoke, tmp_path, monkeypatch):
    """``write_opiec_corpus`` writes the same bytes for the same seed, in one
    process or in a pool of spawned workers, other bytes for another seed;
    both packages' avro readers read its records, and the extractor keeps
    the confident POSITIVE ones (about 0.97 x 0.875 of them)."""
    import sys as _sys

    from open_knowledge_graph_embeddings_tpu.preprocessing import avro as jax_avro
    from open_knowledge_graph_embeddings_tpu_torch.preprocessing import avro
    from open_knowledge_graph_embeddings_tpu_torch.preprocessing.corpus import iter_opiec_triples

    monkeypatch.setitem(_sys.modules, "chip_smoke", smoke)  # the spawned workers import it by name
    runs = {name: smoke.write_opiec_corpus(tmp_path / name, n_records=3001, seed=seed, n_files=2, workers=workers)
            for name, seed, workers in (("a", 0, 1), ("b", 0, 2), ("c", 1, 1))}
    read = {name: [open(p, "rb").read() for p in paths] for name, paths in runs.items()}
    assert read["a"] == read["b"] and read["a"] != read["c"]
    with open(runs["a"][0], "rb") as f:
        records = list(avro.reader(f))
    with open(runs["a"][0], "rb") as f:
        assert records == list(jax_avro.reader(f))
    assert len(records) == 1501 and all(1 <= len(r["subject"]) <= 10 for r in records)
    kept = list(iter_opiec_triples(runs["a"]))
    assert 0.8 * 3001 < len(kept) < 0.9 * 3001
    linked = sum(t["subject_link"] is not None for t in kept) / len(kept)
    assert 0.7 < linked < 0.8


def test_pipeline_config_and_thorough_check(smoke, tmp_path):
    """``pipeline_config`` keeps acl2020's settings; ``test_pairs_in_thorough``
    counts a thorough-train triple that meets a test mention pair."""
    import yaml

    cfg = yaml.safe_load(smoke.pipeline_config(tmp_path / "work", ["a.avro"]).read_text())
    assert (cfg["eval_data_size"], cfg["min_count"], cfg["mention_vocab_size"], cfg["relation_vocab_size"]) == (
        10000, 3, 200000, 50000)
    assert cfg["corpus_files"] == ["a.avro"] and cfg["work_dir"] == str(tmp_path / "work")
    (tmp_path / "test_data.txt").write_text("a\tr\tb\ta|||x a\tb\n")
    (tmp_path / "train_data_thorough.txt").write_text("c\tr\td\tc\td\n")
    assert smoke.test_pairs_in_thorough(tmp_path) == (4, 0)
    (tmp_path / "train_data_thorough.txt").write_text("c\tr\td\tc\td\nb\tq\tx a\tb\tx a\n")
    assert smoke.test_pairs_in_thorough(tmp_path) == (4, 1)


def test_split_checkpoint_reads_back_in_both_packages(smoke, tmp_path):
    """``split_checkpoint``'s two rank slabs: JAX's ``_ShardReader`` and the
    port's reader give every leaf of the original back, the entry names
    recur across the slabs, scalars and short leaves whole in rank 0."""
    from open_knowledge_graph_embeddings_tpu.train.checkpoint import _ShardReader
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import open_checkpoint_reader, save_checkpoint

    rng = np.random.default_rng(3)
    tree = {"table": torch.from_numpy(rng.standard_normal((7, 4)).astype(np.float32)),
            "lstm": {"w": torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)),
                     "b": torch.from_numpy(rng.standard_normal(16).astype(np.float32))},
            "one": torch.ones(1)}
    opt = {"table": {"sum": torch.from_numpy(rng.random((7, 4)).astype(np.float32)), "step": torch.tensor(5.0)}}
    src = save_checkpoint(str(tmp_path), "ck", {"params": tree, "state": {}}, {"training_steps": 5}, opt)
    dst = smoke.split_checkpoint(src, tmp_path / "slabs")
    with np.load(f"{src}/arrays.npz") as z:
        want = {k: z[k] for k in z.files}
    with np.load(f"{dst}/arrays.p0.npz") as a, np.load(f"{dst}/arrays.p1.npz") as b:
        assert set(b.files) < set(a.files) and "params/table::0" in b.files
        assert "opt/table/step::0" not in b.files and "params/one::0" not in b.files
    jax_reader, port_reader = _ShardReader(dst), open_checkpoint_reader(dst)
    assert sorted(jax_reader.keys()) == sorted(port_reader.keys()) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(jax_reader.read_full(k)), w, err_msg=k)
        np.testing.assert_array_equal(port_reader.read_full(k), w, err_msg=k)
    port_reader.close()
    assert json.loads((tmp_path / "slabs" / "meta.json").read_text()) == {"training_steps": 5}


def test_merge_checkpoint_inverts_split(smoke, tmp_path):
    """``merge_checkpoint`` (the data-parallel phase's single-file twin of a
    per-shard save) gives back every leaf of the slabs it reads."""
    from open_knowledge_graph_embeddings_tpu_torch.train.checkpoint import save_checkpoint

    rng = np.random.default_rng(4)
    tree = {"table": torch.from_numpy(rng.standard_normal((9, 3)).astype(np.float32)), "b": torch.ones(2)}
    src = save_checkpoint(str(tmp_path), "ck", {"params": tree, "state": {}}, {"training_steps": 2},
                          {"table": {"sum": torch.zeros(9, 3), "step": torch.tensor(2.0)}})
    merged = smoke.merge_checkpoint(smoke.split_checkpoint(src, tmp_path / "slabs"), tmp_path / "merged")
    with np.load(f"{src}/arrays.npz") as want, np.load(f"{merged}/arrays.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads((tmp_path / "merged" / "meta.json").read_text()) == {"training_steps": 2}


def test_leaf_fingerprints_see_one_flipped_bit(smoke):
    """The replicas' per-step fingerprint: equal trees give equal
    fingerprints, one flipped low bit of one leaf changes that leaf's."""
    rng = np.random.default_rng(5)
    a = {"w": torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32)),
         "s": {"x": torch.arange(3, dtype=torch.bfloat16)}}
    b = {"w": a["w"].clone(), "s": {"x": a["s"]["x"].clone()}}
    assert torch.equal(smoke.leaf_fingerprints(torch, [a]), smoke.leaf_fingerprints(torch, [b]))
    b["w"].view(torch.int32)[2, 3] ^= 1
    fa, fb = smoke.leaf_fingerprints(torch, [a]), smoke.leaf_fingerprints(torch, [b])
    assert fa[0] != fb[0] and fa[1] == fb[1]


def test_deterministic_sites_route_only_their_callers(smoke):
    """The repeat probe's switch: ``index_add_`` from the token-table
    scatters or the BCE positives' backward becomes a deterministic
    ``index_put_(accumulate=True)``, site by site, with the same sums; the
    original method is back afterwards."""
    from open_knowledge_graph_embeddings_tpu_torch.models import embedders as emb
    from open_knowledge_graph_embeddings_tpu_torch.train import loss as loss_mod

    calls = []
    orig_put, orig_add = torch.Tensor.index_put_, torch.Tensor.index_add_

    def put(self, *a, **k):
        calls.append(1)
        return orig_put(self, *a, **k)

    gen = torch.Generator().manual_seed(0)
    table = torch.randn(20, 4, generator=gen, requires_grad=True)
    toks = torch.randint(0, 20, (3, 5), generator=gen)
    q = torch.randn(5, 4, generator=gen, requires_grad=True)
    c = torch.randn(6, 4, generator=gen, requires_grad=True)

    def grads():
        for t in (table, q, c):
            t.grad = None
        emb.token_gather_tm(table, toks, torch.float32).sum().backward()
        loss_mod.bce_over_scores(q, c, torch.tensor([0, 1, 1, -1]), torch.tensor([2, 3, 0, -1]),
                                 torch.ones(5, dtype=torch.bool), None, torch.tensor(6.0)).backward()
        return [t.grad.clone() for t in (table, q, c)]

    want = grads()
    torch.Tensor.index_put_ = put
    try:
        for sites, n in (((), 0), (("token scatters",), 1), (("bce positives",), 2),
                         (("token scatters", "bce positives"), 3)):
            calls.clear()
            with smoke.deterministic_sites(torch, sites):
                got = grads()
            assert len(calls) == n, sites
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    finally:
        torch.Tensor.index_put_ = orig_put
    assert torch.Tensor.index_add_ is orig_add


def test_model_axis_gradients_are_held_by_slab_rows(smoke):
    """``grads_against`` (the model-axis phase's first-step check): a rank's
    slab is held to its rows of the world of one's leaf (JAX's ceil(n/M)
    placement, 7 rows as 4 + 3), a whole leaf as it is; a slab half its
    value (a reduction over the wrong group) fails both rules."""
    rng = np.random.default_rng(6)
    want = [rng.standard_normal((7, 3)), rng.standard_normal(5)]
    ranks = [[want[0][:4] * (1 + 1e-7), want[1]], [want[0][4:], want[1]]]
    worst, worst_max = smoke.grads_against("t", ranks, want, 2, 1e-5)
    assert 0 < worst == worst_max < 1e-6
    assert smoke.grads_against("t", ranks, want, 2, 1e-5, l2=True)[0] < 1e-6
    bad = [[want[0][:4] / 2, want[1]], ranks[1]]
    for l2 in (False, True):
        with pytest.raises(smoke.SmokeFailure):
            smoke.grads_against("t", bad, want, 2, 2.0 ** -4, l2=l2)


def test_model_axis_launches_count_three_passes(smoke):
    """``mp_launches``: a model-axis step runs three LSTM passes (the
    candidate block, the query entities, the relations) forward and
    backward, a batch-shared validation batch three forward passes, and a
    test eval the cache chunks of the rank's slab and two passes a batch."""
    from types import SimpleNamespace

    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import DatasetMeta
    from open_knowledge_graph_embeddings_tpu_torch.models.embedders import LSTMEmbedder
    from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import Mesh

    meta = DatasetMeta(100_003, 10, 2, 2, 50, 20, (10, 10), entity_token_ids=np.zeros((100_003, 10), np.int32),
                       relation_token_ids=np.zeros((10, 10), np.int32))
    emb = LSTMEmbedder(meta=meta, entity_slot_size=16, dtype="bfloat16")
    log = [{"sparse_tables": ("entity_token_embedding",)}, {"sparse_tables": ()}]
    names = ["lstm_last_fwd", "lstm_last_bwd", "adagrad_update", "scatter_adagrad"]
    for rank, chunks in ((0, 2), (1, 2)):  # slabs of 50,002 and 50,001 rows
        trainer = SimpleNamespace(step_log=log, model=SimpleNamespace(embedder=emb, meta=meta),
                                  mesh=Mesh(1, 2, rank), val_builder=[0, 0, 0])
        want = smoke.mp_launches(names, trainer, 4)
        fwd, bwd = smoke.forward_launches(10, "bfloat16"), smoke.backward_launches(10, "bfloat16")
        assert want == {"lstm_last_fwd": 3 * (2 + 4) * fwd, "lstm_last_bwd": 3 * 2 * bwd, "adagrad_update": 2,
                        "scatter_adagrad": 1}
        ev = smoke.mp_launches(names, SimpleNamespace(**{**vars(trainer), "step_log": []}), 0, evaluate=True)
        assert ev["lstm_last_fwd"] == (chunks + 2 * 3) * fwd and ev["lstm_last_bwd"] == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "torch.float32"])
def test_scan_device_want_splits_rows_into_functions(smoke, dtype):
    """The device launches of kernels 1-4 by CUDA function from the counted
    rows: at L = 10 a bf16 forward call is 10 step launches and a backward
    21 (10 gate, 10 product, 1 dW); at f32 one more each, the weight split,
    one function for both; a count that is no whole number of calls fails."""
    f32 = dtype.endswith("float32")
    rows = {"lstm_last_fwd": 6 * (10 + f32), "lstm_last_bwd": 4 * (21 + f32), "adagrad_update": 3,
            "scatter_adagrad": 2}
    want = smoke.scan_device_want(dtype, 10, rows)
    if f32:
        assert want == {"adagrad_dense_kernel": 3, "adagrad_rows_kernel": 2, "lstm_split_kernel_tf32": 10,
                        "lstm_fwd_step_kernel_tf32": 60, "lstm_bwd_gate_kernel_tf32": 40,
                        "lstm_bwd_product_kernel_tf32": 40, "lstm_bwd_dw_kernel_tf32": 4}
    else:
        assert want == {"adagrad_dense_kernel": 3, "adagrad_rows_kernel": 2, "lstm_last_step_kernel": 60,
                        "lstm_bwd_gate_kernel_bf16": 40, "lstm_bwd_product_kernel_bf16": 40,
                        "lstm_bwd_dw_kernel_bf16": 4}
    with pytest.raises(smoke.SmokeFailure):
        smoke.scan_device_want(dtype, 10, {**rows, "lstm_last_bwd": rows["lstm_last_bwd"] + 1})


def test_counted_steps_leave_out_replays(smoke):
    """The kernel counters see single steps, eager windows and captures; a
    replayed window launches through no wrapper."""
    log = [{"window": k} for k in (None, "eager", "eager", "capture", "capture", "replay", "replay", None)]
    assert [s["window"] for s in smoke.counted_steps(log)] == [None, "eager", "eager", "capture", "capture", None]


def test_state_gap_is_relative_to_each_leafs_largest(smoke):
    want = {"a": torch.tensor([1.0, -4.0]), "b": torch.tensor([0.5]), "empty": torch.zeros(0)}
    got = {"a": torch.tensor([1.5, -4.0]), "b": torch.tensor([0.5]), "empty": torch.zeros(0)}
    assert smoke.state_gap(got, want) == (0.125, "a")
    assert smoke.state_gap(want, want)[0] == 0.0


@pytest.fixture(scope="module")
def window_states(smoke, toy_dataset_dir):
    """A toy token model (row-sparse tables, dropout, batchnorm) before a
    window of 3 steps, after it, and after its first 2 steps, each run with
    ``ScannedStep.single`` from the same state and generator state."""
    from open_knowledge_graph_embeddings_tpu_torch.data.batching import BatchBuilder
    from open_knowledge_graph_embeddings_tpu_torch.data.dataset import OneToNMentionRelationDataset
    from open_knowledge_graph_embeddings_tpu_torch.models.model import build_model
    from open_knowledge_graph_embeddings_tpu_torch.train.optim import OptimizerRegimes
    from open_knowledge_graph_embeddings_tpu_torch.train.sparse import SparsePlanBuilder, make_sparse_train_step
    from open_knowledge_graph_embeddings_tpu_torch.train.step import arrays_to_device, make_scanned_step

    ds = OneToNMentionRelationDataset(dataset_dir=toy_dataset_dir, input_file="train.txt", is_training_data=True,
                                      batch_size=2, use_batch_shared_entities=True, min_size_batch_labels=6)
    model = build_model("LSTMComplexRelationModel", ds.meta, entity_slot_size=8, init_std=0.1, sparse=True,
                        dropout=0.3, normalize="batchnorm")
    reg = OptimizerRegimes({"optimizer": "Adagrad", "lr": 0.2})
    reg.update(1, 0)
    plan = SparsePlanBuilder(model.embedder, entity_sparse=True, min_rows_ratio=0.0)
    batches = [arrays_to_device(plan(b), "cpu") for b in BatchBuilder(ds, seed=2).batches()][:3]
    v = model.init(torch.Generator().manual_seed(0))
    opt = reg.init_state(v["params"])
    scanned = make_scanned_step(make_sparse_train_step(model, reg, v["params"], entity_sparse=True), 3)
    before = {k: t.clone() for k, t in smoke.flat_state(v, opt).items()}

    def run(n):
        for k, t in smoke.flat_state(v, opt).items():
            t.copy_(before[k])
        gen = torch.Generator().manual_seed(5)
        for b in batches[:n]:
            scanned.single(v, opt, reg.hparams(), b, gen)
        return {k: t.clone() for k, t in smoke.flat_state(v, opt).items()}

    return before, run(3), run(2)


def test_window_rule_holds_a_twin_and_fails_the_controls(smoke, window_states):
    """``window_rule``: an eager twin of the window passes, and so does one
    whose moved entries carry noise within the allowed gap; the state left
    as it was, the window one step short and the window with its largest
    table's update left out each fail it, whatever the allowed gap."""
    before, after, short = window_states
    assert smoke.window_rule(after, after, before, 0.0) == []
    noisy = {k: t + 1e-7 * (t != before[k]) * t.abs() if t.is_floating_point() and not k.endswith("/step") else t
             for k, t in after.items()}
    gap = smoke.state_gap(noisy, after)[0]
    assert 0 < gap and smoke.window_rule(noisy, after, before, gap / smoke.SCAN_RULE_FACTOR) == []
    assert smoke.window_rule(noisy, after, before, 0.0)
    reverted = smoke.largest_table_reverted(after, before)
    largest = max((k for k in after if k.startswith("params/")), key=lambda k: after[k].numel())
    table = largest[len("params/"):]
    assert {k for k in after if reverted[k] is before[k]} == {largest, f"opt/{table}/sum", f"opt/{table}/step"}
    for control in (before, short, reverted):
        fails = smoke.window_rule(control, after, before, 1e30)
        assert fails and all("largest leaf gap" not in f for f in fails), fails
    assert any("step counters" in f for f in smoke.window_rule(short, after, before, 1e30))
    assert smoke.movement_gap(before, after, before)[0] == pytest.approx(1.0)
    assert smoke.movement_gap(after, after, before)[0] == 0.0


def test_moved_leaves(smoke):
    before = {"t": torch.zeros(3, 2), "b": torch.zeros(4), "s": torch.tensor(1.0), "e": torch.zeros(0, 2)}
    after = {"t": torch.tensor([[0.0, 0.0], [0.0, 1.0], [0.0, 0.0]]), "b": torch.zeros(4), "s": torch.tensor(2.0),
             "e": torch.zeros(0, 2)}
    assert smoke.moved_leaves(after, before) == {"t", "s"}


def test_backward_f64_agreement_holds_plain_and_fails_a_scaled_dw(smoke, lstm_case):
    """The captured path's rule for kernel 2: each output against f64
    within twice the plain version's error; the plain version passes it, a
    dW_ih one percent off fails."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    _, _, bargs = lstm_case
    want = lk.lstm_last_backward_plain(*bargs)
    ok, text, _ = smoke.backward_f64_agreement(torch, bargs, want, want)
    assert ok, text
    off = (want[0], want[1] * 1.01, want[2], want[3])
    ok, text, _ = smoke.backward_f64_agreement(torch, bargs, off, want)
    assert not ok, text


def test_forward_f64_agreement_holds_plain_and_fails_a_late_hs(smoke, lstm_case):
    """The captured path's rule for kernel 1: last, hs and cs against the
    recurrence in f64 within twice the plain version's error; the plain
    version passes it, residuals one step late fail."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    args, _, _ = lstm_case
    want = lk.lstm_encode_last_plain(*args, residuals=True)
    ok, text, _ = smoke.forward_f64_agreement(torch, args, want, want)
    assert ok, text
    late = (want[0], torch.cat([want[1][:1], want[1][:-1]]), want[2])
    ok, text, _ = smoke.forward_f64_agreement(torch, args, late, want)
    assert not ok, text


FAKE_RANK = """import json, sys, time
rank, world, out, config = int(sys.argv[2]), int(sys.argv[3]), sys.argv[5], sys.argv[6]
time.sleep(float(config.split(":")[1]))
if config.startswith("fail") and rank == world - 1:
    sys.exit(3)
json.dump({"rank": rank, "launches": {"k": 1}, "want": {"k": 1}}, open(out, "w"))
print(f"dp rank {rank}: done")
"""


def test_ranks_run_side_by_side(smoke, tmp_path, monkeypatch):
    """``run_side_by_side``: runs of ``start_ranks`` and an in-process call
    at once, each run's seconds ending at its own exit, each its own
    rendezvous port; a failing rank ends every run and fails the phase
    with its own exit first."""
    script = tmp_path / "fake_rank.py"
    script.write_text(FAKE_RANK)
    monkeypatch.setattr(smoke, "RANK_SCRIPT", script)
    monkeypatch.setattr(smoke, "ROOT", tmp_path)
    t0 = smoke.time.perf_counter()
    (one, two), got = smoke.run_side_by_side([("one", "ok:0.2", 1), ("two", "ok:1.5", 2)],
                                             beside=lambda: smoke.time.sleep(1.0) or "beside")
    took = smoke.time.perf_counter() - t0
    assert got == "beside" and [r["rank"] for r in two[0]] == [0, 1] and one[0][0]["rank"] == 0
    assert one[1] < 1.0 < two[1] < took < 3.0, (one[1], two[1], took)
    assert len(smoke.PORTS_GIVEN) >= 2
    real_start, started = smoke.start_ranks, []
    monkeypatch.setattr(smoke, "start_ranks", lambda *a: started.append(real_start(*a)) or started[-1])
    with pytest.raises(smoke.SmokeFailure, match="bad: rank 1 exited 3"):
        smoke.run_side_by_side([("slow", "ok:30", 2), ("bad", "fail:0.1", 2)])
    assert len(started) == 2 and all(p.poll() is not None for job in started for p, _ in job["procs"])
    assert smoke.time.perf_counter() - t0 < 20
    assert smoke.run_ranks("alone", "ok:0", 1)[0][0]["launches"] == {"k": 1}


def test_bf16_gradients_held_against_the_f32_world_of_one(smoke, tmp_path):
    """``bf16_against_f32``: a run on ranks passes while its distance to
    the f32 gradients is within ``DP_BF16_FACTOR`` x the bf16 world of
    one's, and fails past it."""
    rng = np.random.default_rng(0)
    ref = [rng.standard_normal((8, 4)), rng.standard_normal(8)]
    noise = [rng.standard_normal(w.shape) for w in ref]

    def write(name, scale):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        for suffix in (".grads.npz", ".rows.npz"):
            np.savez(d / f"rank0{suffix}", *[w + scale * n for w, n in zip(ref, noise)])
        return d

    ref_dir, one_dir = write("ref", 0.0), write("one", 0.01)
    ratio = smoke.bf16_against_f32(write("two", 0.015), one_dir, ref_dir)
    assert ratio == pytest.approx(1.5)
    with pytest.raises(smoke.SmokeFailure, match="from the f32 world of one's"):
        smoke.bf16_against_f32(write("far", 0.03), one_dir, ref_dir)
