"""Kernel 1's host side on the CPU: the persistent grid the wrapper launches,
and the shape of the CUDA source (it cannot be compiled here)."""

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
