"""Kernel 1's host side on the CPU: the persistent grid the wrapper launches,
and the shape of the CUDA source (it cannot be compiled here); the same for
the f32 backward (kernels 2 and 6 at f32, 3xTF32 on the tensor cores)."""

import pathlib
import re

import pytest

from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_kernel

CSRC = pathlib.Path(lstm_kernel.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize(
    "B,H,n_sm,grid",
    [
        (32768, 512, 132, 132),  # a cache chunk: 256 row tiles x 16 unit tiles
        (5632, 512, 132, 132),  # the training entity pass: 44 x 16
        (3072, 512, 132, 132),  # the relation pass: 24 x 16
        (1, 512, 132, 16),  # one row: one row tile x 16 unit tiles
        (129, 40, 132, 4),  # two row tiles x one unit tile (40 units: a tail)
        (4099, 64, 132, 66),  # 33 x 2
        (4099, 64, 8, 8),  # a smaller card
        (0, 512, 132, 1),  # nothing to do: still a valid launch shape
    ],
)
def test_forward_grid_is_one_block_per_sm_or_per_tile(B, H, n_sm, grid):
    assert lstm_kernel.forward_grid(B, H, n_sm) == grid


def test_forward_source_is_a_hopper_kernel():
    """The step kernel takes its tiles by TMA into an mbarrier ring and
    multiplies them with wgmma; the old mma.sync gate product is not on its
    path (it stays for the backwards)."""
    src = (CSRC / "lstm_last_fwd.cu").read_text()
    helpers = (CSRC / "lstm_sm90.cuh").read_text()
    assert "wgmma.mma_async" in helpers and "cp.async.bulk.tensor" in helpers and "mbarrier" in helpers
    for call in ("wgmma_m64n128k16(", "tma_load_3d(", "mbar_wait(", "setmaxnreg_inc<"):
        assert call in src, call
    assert not re.search(r"\b(gate_product|mma_bf16|cp_async16)\(", src)
    assert "lstm_sm90.cuh" in src and "_fused_fwd_last" in src


@pytest.mark.parametrize(
    "B,H,D,n_sm,grid",
    [
        (5632, 512, 512, 132, 132),  # the training entity pass: 44 row tiles x 8 column tiles
        (3072, 512, 512, 132, 132),  # the relation pass: 24 x 8
        (37, 100, 132, 132, 2),  # one row tile x 232 columns (a tail)
        (1, 128, 256, 132, 3),  # one row: 384 columns
        (4099, 64, 64, 8, 8),  # a smaller card
        (0, 512, 512, 132, 1),  # nothing to do: still a valid launch shape
    ],
)
def test_backward_product_grid_is_one_block_per_sm_or_per_tile(B, H, D, n_sm, grid):
    assert lstm_kernel.backward_product_grid(B, H, D, n_sm) == grid


def test_f32_backward_source_is_3xtf32_on_the_tensor_cores():
    """The f32 entries of the backward split their operands and multiply on
    the tensor cores (wgmma for the gate and product launches, mma.sync for
    dW); no FFMA product is left on their path."""
    src = (CSRC / "lstm_last_bwd.cu").read_text()
    helpers = (CSRC / "lstm_sm90.cuh").read_text()
    assert "tf32_split(" in helpers and "0xFFFFE000u" in helpers and "m64n128k8.f32.tf32.tf32" in helpers
    f32 = src[src.index("// ------------------------------------------------------------------ f32 mode"):]
    for call in ("tf32_split(", "wgmma_m64n128k8_tf32(", "tma_load_3d(", "mma_tf32(", "setmaxnreg_inc<"):
        assert call in f32, call
    assert not re.search(r"\b(fmaf|fma4|gate_product_f32|launch_bwd_product_f32)\(", f32)
    assert '#include "lstm_f32.cuh"' not in src
    for entry in ("split", "gate", "product", "dw"):
        assert f'extern "C" int oket_lstm_bwd_{entry}_f32(' in src
