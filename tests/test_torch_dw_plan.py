"""The names by which ``chip_smoke.py`` finds the bf16 and f32 dW launches
(``csrc/lstm_last_bwd.cu``) in a profile, its launch split failing a kind
with no device time, and no source left on ``mma.sync``.  The launches
themselves run on the card only (``tests/test_torch_cuda.py``)."""

import importlib.util
import pathlib
import re
from types import SimpleNamespace

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_finds_the_dw_launch_by_its_kernel_name():
    """chip_smoke.py reads the dW launch's device time and counts by the
    kernel's name: the names it looks for are the source's."""
    smoke = _smoke()
    src = (ROOT / "open_knowledge_graph_embeddings_tpu_torch" / "csrc" / "lstm_last_bwd.cu").read_text()
    kernels = set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", src))
    assert smoke.BACKWARD_BF16_KINDS["dW"] in kernels
    assert smoke.SCAN_FUNCTIONS["bf16"][-1] in kernels
    # the prefix that finds a parent's dW launch too finds this one
    assert smoke.BACKWARD_BF16_KINDS["dW"].startswith(smoke.BACKWARD_BF16_KINDS_ANY_TREE["dW"])
    assert "lstm_bwd_dw_kernel(" not in src  # the mma.sync launch is gone


CSRC = ROOT / "open_knowledge_graph_embeddings_tpu_torch" / "csrc"


def _kernel_names(*sources):
    text = "".join((CSRC / name).read_text() for name in sources)
    return set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", text))


def test_chip_smoke_finds_the_f32_launches_by_their_kernel_names():
    """chip_smoke.py reads the f32 backward's device time and counts by
    kind (split, gate, product, dW) through a part of each kernel's name:
    each part names exactly one kernel of the sources, and the prefix that
    finds a parent's f32 dW launch finds this one."""
    smoke = _smoke()
    kernels = _kernel_names("lstm_last_bwd.cu", "lstm_tf32.cuh")
    found = {kind: [k for k in kernels if sub in k] for kind, sub in smoke.BACKWARD_F32_KINDS.items()}
    assert all(len(names) == 1 for names in found.values()), found
    assert found["dW"][0].startswith(smoke.BACKWARD_F32_KINDS_ANY_TREE["dW"])
    assert set(smoke.BACKWARD_F32_KINDS_ANY_TREE) == set(smoke.BACKWARD_F32_KINDS)


def test_no_source_issues_mma_sync():
    """Every product of the port's kernels runs on wgmma: no CUDA source
    holds the instruction string of the pre-Hopper warp-level product (a
    comment on the history names it without its ``.aligned`` suffix)."""
    sources = sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    assert sources
    assert [p.name for p in sources if "mma.sync.aligned" in p.read_text()] == []


def test_the_dw_entries_take_their_variants_by_name():
    """The wrapper's variant tables match the C entries: the f32 dW entry
    takes 3xTF32, the planted 1xTF32 check and the loads alone; the bf16
    one the kernel and the loads alone (the codes the entries test)."""
    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel as lk

    src = (CSRC / "lstm_last_bwd.cu").read_text()
    entry = src[src.index('extern "C" int oket_lstm_bwd_dw_f32('):]
    assert lk.DW_F32_VARIANTS == {"kernel": 0, "1xTF32": 1, "no products": 2}
    assert _enum((CSRC / "lstm_tf32.cuh").read_text(), "Variant") == {"X3": 0, "X1": 1, "NO_PRODUCTS": 2}
    taken = re.findall(r"variant\s*==\s*(\w+)\s*\)\s*return\s+launch_dw\s*<\s*(\w+)\s*>", entry)
    assert sorted(taken) == [("NO_PRODUCTS", "NO_PRODUCTS"), ("X1", "X1"), ("X3", "X3")]
    assert lk.DW_VARIANTS == {"kernel": 0, "no products": 1}
    assert _enum(src, "DwVariant") == {"DW_KERNEL": 0, "DW_NO_PRODUCTS": 1}


def _enum(text, name):
    """The values of C enum ``name`` in ``text``, by enumerator."""
    body = re.search(rf"enum\s+{name}\s*\{{([^}}]*)\}}", text).group(1)
    return {k.strip(): int(v) for k, v in (e.split("=") for e in body.split(",") if e.strip())}


class _Trace:
    """torch.profiler.profile on the CPU: the device µs of one bf16
    backward's launches over the five profiled calls, by kernel name."""

    names = {}

    def __init__(self, activities=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return [SimpleNamespace(key=k, self_device_time_total=v, count=n) for k, (v, n) in self.names.items()]


F32_NAMES = {
    "void (anonymous namespace)::tf32::lstm_bwd_gate_kernel_tf32<0, true>(...)": (1250.0, 50),
    "void (anonymous namespace)::tf32::lstm_bwd_product_kernel_tf32<0, true>(...)": (1100.0, 50),
    "void oket_tf32::lstm_split_kernel_tf32<true>(...)": (100.0, 5)}


@pytest.mark.parametrize("dw_name,ok", [
    ("void (anonymous namespace)::tf32::lstm_bwd_dw_kernel_tf32<0>(...)", True),
    ("void (anonymous namespace)::tf32::lstm_bwd_wgrad_kernel<0>(...)", False),
], ids=["this-tree", "a-dw-kernel-of-another-name"])
def test_f32_backward_split_fails_a_kind_with_no_device_time(monkeypatch, dw_name, ok):
    """The f32 launch split (split, gate, product, dW) reads each kind by
    its kernel's name: no device time under the dW kind's name fails, and
    the prefix of ``BACKWARD_F32_KINDS_ANY_TREE`` reads this tree's dW
    launch as it reads a parent's (the same kernel name)."""
    import torch.profiler

    smoke = _smoke()
    monkeypatch.setattr(torch.profiler, "profile", _Trace)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(_Trace, "names", {**F32_NAMES, dw_name: (4000.0, 5)})
    emb = torch.zeros(10, 64, 8, dtype=torch.float32)
    args = (emb, None, torch.zeros(32, 8), None, torch.full((64,), 3))
    want = {"split": 0.02, "gate": 0.25, "product": 0.22, "dW": 0.8}
    if ok:
        assert smoke.print_backward_launch_ms(torch, "lstm_last_bwd_f32", args, lambda: None) == pytest.approx(want)
        by_kind = smoke.print_backward_launch_ms(torch, "lstm_last_bwd_f32", args, lambda: None,
                                                 kinds=smoke.BACKWARD_F32_KINDS_ANY_TREE)
        assert by_kind == pytest.approx(want)
    else:
        with pytest.raises(smoke.SmokeFailure, match="no device time for the kinds \\['dW'\\]"):
            smoke.print_backward_launch_ms(torch, "lstm_last_bwd_f32", args, lambda: None)


@pytest.mark.parametrize("dw_name,ok", [
    ("void (anonymous namespace)::bf16::lstm_bwd_dw_kernel_bf16<0>(...)", True),
    ("(anonymous namespace)::lstm_bwd_dw_kernel((anonymous namespace)::DwArgs)", False),
], ids=["this-tree", "a-dw-kernel-of-another-name"])
def test_backward_split_fails_a_kind_with_no_device_time(monkeypatch, dw_name, ok):
    """The launch split reads each kind's device time by its kernel's name:
    a trace with time for the gate and product launches and none under the
    dW kind's name (a kernel renamed away from it) fails instead of reading
    dW as free."""
    import torch.profiler

    smoke = _smoke()
    monkeypatch.setattr(torch.profiler, "profile", _Trace)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    # (µs, launches) over the five calls: L = 10 gate and product launches a
    # call, one dW
    monkeypatch.setattr(_Trace, "names", {
        "void (anonymous namespace)::bf16::lstm_bwd_gate_kernel_bf16<0>(...)": (1500.0, 50),
        "(anonymous namespace)::bf16::lstm_bwd_product_kernel_bf16(...)": (1000.0, 50), dw_name: (2000.0, 5)})
    emb = torch.zeros(10, 64, 8, dtype=torch.bfloat16)
    args = (emb, None, torch.zeros(32, 8), None, torch.full((64,), 3))
    if ok:
        assert smoke.print_backward_launch_ms(torch, "lstm_last_bwd", args, lambda: None) == pytest.approx(
            {"gate": 0.3, "product": 0.2, "dW": 0.4})
    else:
        with pytest.raises(smoke.SmokeFailure, match="no device time for the kinds \\['dW'\\]"):
            smoke.print_backward_launch_ms(torch, "lstm_last_bwd", args, lambda: None)
    # a parent's dW launch is found by the prefix both names share
    by_kind = smoke.print_backward_launch_ms(torch, "lstm_last_bwd", args, lambda: None,
                                             kinds=smoke.BACKWARD_BF16_KINDS_ANY_TREE)
    assert by_kind["dW"] == pytest.approx(0.4)


def test_backward_split_retakes_a_trace_short_of_records(monkeypatch, capsys):
    """A trace that lost its first GPU records (the gate launches of the
    first calls, so every kind but the last short of its launches) is taken
    again and, never whole, read as not measured: no failure and no number
    from a part of the launches."""
    import torch.profiler

    smoke = _smoke()
    taken = []

    class Short(_Trace):
        def __init__(self, activities=None):
            taken.append(1)

    monkeypatch.setattr(torch.profiler, "profile", Short)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(Short, "names", {
        "void (anonymous namespace)::bf16::lstm_bwd_gate_kernel_bf16<0>(...)": (300.0, 10),
        "(anonymous namespace)::bf16::lstm_bwd_product_kernel_bf16(...)": (400.0, 20),
        "void (anonymous namespace)::bf16::lstm_bwd_dw_kernel_bf16<0>(...)": (1600.0, 4)})
    emb = torch.zeros(10, 64, 8, dtype=torch.bfloat16)
    args = (emb, None, torch.zeros(32, 8), None, torch.full((64,), 3))
    assert smoke.print_backward_launch_ms(torch, "lstm_last_bwd", args, lambda: None) is None
    assert len(taken) == smoke.LAUNCH_TRACE_TRIES
    out = capsys.readouterr().out
    assert "(records lost)" in out and "no whole trace of the call's launches (not measured)" in out
