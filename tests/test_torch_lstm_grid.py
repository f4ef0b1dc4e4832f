"""Kernel 1's host side on the CPU: the persistent grid the wrapper launches,
and the shape of the CUDA source (it cannot be compiled here); the same for
the bf16 backward (kernels 2 and 6: the gate launch on kernel 1's loop, the
dh/demb product with wgmma's transposed B), the bf16 recurrence (kernels 7
and 8 on the same loop with D = 0), the f32 forward and backward (3xTF32 on
the tensor cores) and the f32 recurrence (kernels 7 and 8 on the f32 loop
with D = 0)."""

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


def _body(src, name):
    """The body of the function or kernel ``name`` defined in ``src`` (from
    its definition's opening brace to the matching closing one)."""
    m = re.search(r"\b" + re.escape(name) + r"\([^;{]*\)\s*\{", src)
    assert m, name
    depth, i = 0, m.end() - 1
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i:j + 1]
    raise AssertionError(f"unbalanced braces in {name}")


def _bf16_loop():
    """The shared bf16 gate loop (lstm_bf16.cuh: one product loop, which
    kernel 1 and the bf16 backward's gate and product launches run) and the
    Hopper helpers it is built from (lstm_sm90.cuh)."""
    helpers = (CSRC / "lstm_sm90.cuh").read_text()
    assert "wgmma.mma_async" in helpers and "cp.async.bulk.tensor" in helpers and "mbarrier" in helpers
    header = (CSRC / "lstm_bf16.cuh").read_text()
    # one gate loop (kernel 1 and the backward's gate launch) and one
    # folded product loop (the backward's dh/demb product)
    assert len(re.findall(r"__device__ __forceinline__ void tile_products\(", header)) == 1
    assert len(re.findall(r"__device__ __forceinline__ void tile_products_folded\(", header)) == 1
    loop = _body(header, "tile_products")
    for call in ("wgmma_m64n128k16(", "mbar_wait(", "wgmma_desc(", "mbar_arrive(&r.turn[1 - wg])"):
        assert call in loop, call
    assert "tma_load_3d(" in _body(header, "produce_gate_tiles")
    return header


def test_forward_source_is_a_hopper_kernel():
    """The step kernel takes its tiles by TMA into an mbarrier ring and
    multiplies them with wgmma, through the shared loop of lstm_bf16.cuh; no
    mma.sync gate product is on its path."""
    src = (CSRC / "lstm_last_fwd.cu").read_text()
    _bf16_loop()
    kernel = _body(src, "lstm_last_step_kernel")
    for call in ("tile_products<V != NO_PRODUCTS>(", "produce_gate_tiles(", "seed_bias(", "setmaxnreg_inc<"):
        assert call in kernel, call
    assert not re.search(r"\b(gate_product|mma_bf16|cp_async16)\(", src)
    assert '#include "lstm_bf16.cuh"' in src and "_fused_fwd_last" in src


def test_bf16_gate_launch_runs_kernel_1s_loop():
    """The bf16 backward's gate launch recomputes the gates with kernel 1's
    own producer, bias seed and product loop (the K-major form), on the same
    tiles, so its pre-activations are the forward's bit for bit; both
    kernels have the measuring store of those gates.  No mma.sync gate
    product is left in the port (kernels 7 and 8 run the same loop since
    they were redesigned)."""
    _bf16_loop()
    fwd = _body((CSRC / "lstm_last_fwd.cu").read_text(), "lstm_last_step_kernel")
    src = (CSRC / "lstm_last_bwd.cu").read_text()
    gate = _body(src, "lstm_bwd_gate_kernel_bf16")
    assert '#include "lstm_bf16.cuh"' in src
    for body in (fwd, gate):
        for call in ("produce_gate_tiles(", "seed_bias(", "store_gate_tile(", "setmaxnreg_inc<232>"):
            assert call in body, call
        assert re.search(r"tile_products<[^>]+>\(r, q, nk, wg, lane, acc\)", body)
    assert "bwd_cell(" in gate and "db_part" in gate
    assert not re.search(r"\b(gate_product|load_gate_tile|launch_bwd_product|ldmatrix_x4_trans)\(", src)
    for name in ("lstm_gates.cuh", "lstm_scan.cu"):
        assert not re.search(r"\b(gate_product|load_gate_tile)\(", (CSRC / name).read_text()), name
    assert 'extern "C" int oket_lstm_bwd_gate_bf16(' in src


def test_bf16_product_launch_is_wgmma_with_transposed_b():
    """The bf16 dh/demb product launch runs the ring of lstm_bf16.cuh with
    wgmma m64n128k16 in its transposed-B form, the gate-major weights read
    as they are by TMA (two 64-column boxes a stage, no transposed copy),
    each K stage folded into an f32 sum (lstm_bf16.cuh::product_tiles,
    which kernel 8's product launch runs too); the old ldmatrix.trans
    product is gone."""
    header = _bf16_loop()
    helpers = (CSRC / "lstm_sm90.cuh").read_text()
    mma = _body(helpers, "wgmma_m64n128k16")
    assert "m64n128k16.f32.bf16.bf16" in mma and '"n"(TRANS_A), "n"(TRANS_B)' in mma and "1, 1, %67, %68" in mma
    folded = _body(header, "tile_products_folded")
    assert "wgmma_m64n128k16<0, 1>(" in folded and "wgmma_desc_mn(w + kk * 2048, W_BYTES / 2)" in folded
    assert "sum[i] +=" in folded  # the fold: each stage added to the f32 sum
    src = (CSRC / "lstm_last_bwd.cu").read_text()
    prod = _body(header, "product_tiles")
    assert "tile_products_folded(r, q, nk, wg, lane, acc)" in prod and "make_ring<RingBf16>(smem_raw, 8)" in prod
    assert prod.count("tma_load_3d(") == 3 and "mbar_arrive_expect_tx(" in prod
    assert "if (p.D > 0) tma_prefetch_map(map_wih);" in prod  # no W_ih map at D = 0 (kernel 8)
    assert not re.search(r"\b(mma_bf16|ldmatrix_x4_trans|cp_async16|transpose)\w*\(", prod)
    assert "product_tiles(smem_raw, &map_dg, &map_whh, &map_wih, p, active_prefix<THREADS>(lens, p.B, p.t))" in _body(
        src, "lstm_bwd_product_kernel_bf16")
    assert 'extern "C" int oket_lstm_bwd_product_bf16(' in src
    assert not (CSRC / "lstm_product.cuh").exists()
    assert not re.search(r"\b(launch_bwd_product|ldmatrix_x4_trans)\(", (CSRC / "lstm_scan.cu").read_text())


def test_bf16_scan_kernels_run_kernel_1s_loop():
    """Kernels 7 and 8 in bf16 run kernel 1's loop with D = 0: one function
    (scan_gate_tiles) gives kernel 7 and kernel 8's gate launch their
    products from zero, x_proj added after them in f32 and the measuring
    store of the gates, so the two recompute the same gates bit for bit;
    kernel 8's product launch is the fused backward's (product_tiles) with
    no W_ih map.  No x or W_ih map is made or prefetched at D = 0 (TMA
    refuses a zero extent)."""
    header = _bf16_loop()
    produce = _body(header, "produce_gate_tiles")
    assert "if (nkx > 0) {\n        tma_prefetch_map(map_x);\n        tma_prefetch_map(map_wih);" in produce
    add = _body(header, "add_rows")
    assert "__ldg(src)" in add and "row < B && u < H" in add and "+= v.x" in add
    src = (CSRC / "lstm_scan.cu").read_text()
    bf16 = src[src.index("namespace bf16 {"):src.index("}  // namespace bf16")]
    loop = _body(bf16, "scan_gate_tiles")
    for call in ("acc[m][i] = 0.f", "tile_products<true>(r, q, nk, wg, lane, acc)",
                 "add_rows(xp, B, H, r0, u0, lane, n8, acc)", "store_gate_block(gates, H, B, r0, u0, lane, n8, acc)",
                 "setmaxnreg_inc<232>", "epilogue(acc, r0, u0, lane, finish_gates)",
                 "produce_gate_tiles(r, tiles, unit_tiles, 0, nk, nullptr, map_h, nullptr, map_whh, t, t - 1)"):
        assert call in loop, call
    # x_proj enters after the products and before the measuring store
    order = [loop.index(c) for c in ("tile_products<true>(", "add_rows(", "store_gate_block(", "epilogue(acc")]
    assert order == sorted(order)
    for kernel in ("lstm_scan_step_kernel_bf16", "lstm_scan_bwd_gate_kernel_bf16"):
        body = _body(bf16, kernel)
        assert "scan_gate_tiles<V>(&map_h, &map_whh, p.xp, p.gates, B, H, t," in body, kernel
        # each 8-unit block's gates are finished before the epilogue reads them
        assert body.index("finish_gates(n8);") < body.index("acc[m][n8 * 4 + e]"), kernel
    assert "bwd_cell(" in _body(bf16, "lstm_scan_bwd_gate_kernel_bf16")
    assert "product_tiles(smem_raw, &map_dg, &map_whh, nullptr, p, p.B)" in _body(
        bf16, "lstm_scan_bwd_product_kernel_bf16")
    assert not re.search(r"\b(mma_bf16|cp_async16|gate_product|db_part)\b", bf16)
    for entry in ("step", "bwd_gate", "bwd_product"):
        for dtype in ("bf16", "f32"):
            assert f'extern "C" int oket_lstm_scan_{entry}_{dtype}(' in src


def test_scan_gate_store_is_checked():
    """The measuring store of kernels 7/8's gates takes an f32 [L, B, 4H]
    tensor beside bf16 or f32 inputs at an H the kernels take unpadded, and
    nothing else (it is checked before any launch); it stores what the
    kernel computes, so no other variant takes it."""
    import torch

    from open_knowledge_graph_embeddings_tpu_torch.ops import lstm_scan_kernel as sk

    x_proj = torch.zeros(10, 3, 4 * 64, dtype=torch.bfloat16)
    sk._check_gates_out(None, 10, 3, 64, x_proj)
    sk._check_gates_out(torch.zeros(10, 3, 256), 10, 3, 64, x_proj)
    sk._check_gates_out(torch.zeros(10, 3, 256), 10, 3, 64, x_proj.float())
    sk._check_gates_out(torch.zeros(10, 3, 4 * 100), 10, 3, 100, torch.zeros(10, 3, 400))  # 100: a multiple of 4
    for gates, xp, H in ((torch.zeros(10, 3, 255), x_proj, 64),
                         (torch.zeros(10, 3, 256, dtype=torch.bfloat16), x_proj, 64),
                         (torch.zeros(10, 3, 4 * 100), torch.zeros(10, 3, 400, dtype=torch.bfloat16), 100),
                         (torch.zeros(10, 3, 4 * 37), torch.zeros(10, 3, 4 * 37), 37)):
        with pytest.raises(ValueError):
            sk._check_gates_out(gates, 10, 3, H, xp)
    assert sk._variant_code(torch.float32, "kernel", torch.zeros(1)) == sk._STORE_GATES
    assert sk._variant_code(torch.float32, "1xTF32", None) == sk.F32_VARIANTS["1xTF32"]
    for dtype, variant, gates in ((torch.float32, "1xTF32", torch.zeros(1)), (torch.bfloat16, "1xTF32", None),
                                  (torch.float32, "no epilogue", None)):
        with pytest.raises(ValueError):
            sk._variant_code(dtype, variant, gates)


@pytest.mark.parametrize(
    "B,H,D,n_sm,grid",
    [
        (5632, 512, 512, 132, 132),  # the training entity pass: 44 row tiles x (4 + 4) column tiles
        (3072, 512, 512, 132, 132),  # the relation pass: 24 x 8
        (37, 100, 132, 132, 3),  # one row tile x (1 dh + 2 demb) column tiles: H and D apart
        (37, 40, 40, 132, 2),  # 1 x (1 + 1), where H + D would fit one tile
        (1, 128, 256, 132, 3),  # one row: 1 + 2
        (129, 136, 512, 132, 12),  # 2 x (2 + 4)
        (4099, 64, 64, 8, 8),  # a smaller card
        (0, 512, 512, 132, 1),  # nothing to do: still a valid launch shape
    ],
)
def test_bf16_backward_product_grid_counts_dh_and_demb_tiles_apart(B, H, D, n_sm, grid):
    assert lstm_kernel.backward_product_grid_bf16(B, H, D, n_sm) == grid


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


def _tf32_gate_loop():
    """The shared 3xTF32 gate loop (lstm_tf32.cuh: one loop, which both the
    forward and the backward run) and the Hopper helpers it is built from
    (lstm_sm90.cuh)."""
    helpers = (CSRC / "lstm_sm90.cuh").read_text()
    assert "tf32_split(" in helpers and "0xFFFFE000u" in helpers and "m64n128k8.f32.tf32.tf32" in helpers
    header = (CSRC / "lstm_tf32.cuh").read_text()
    assert len(re.findall(r"__device__ __forceinline__ void tile_products\w*\(", header)) == 1
    return header


def test_f32_backward_source_is_3xtf32_on_the_tensor_cores():
    """The f32 entries of the backward split their operands and multiply on
    the tensor cores: wgmma for the gate and product launches through the
    shared gate loop of lstm_tf32.cuh, and for dW (fed by the shared TMA
    producer, its x / hs operand transposed and split in shared memory); no
    FFMA or mma.sync product is left on their path."""
    src = (CSRC / "lstm_last_bwd.cu").read_text()
    header = _tf32_gate_loop()
    assert '#include "lstm_tf32.cuh"' in src
    f32 = src[src.index("// ------------------------------------------------------------------ f32 mode"):] + header
    for call in ("tf32_split(", "wgmma_m64n128k8_tf32(", "tma_load_3d(", "setmaxnreg_inc<",
                 "tile_products<V, FOLD>(", "produce_dw<DW32_ROWS", "dw_split_transposed("):
        assert call in f32, call
    assert not re.search(r"\b(fmaf|fma4|gate_product_f32|launch_bwd_product_f32|mma_tf32|cp_async16)\(", f32)
    assert '#include "lstm_f32.cuh"' not in src
    for entry in ("split", "gate", "product", "dw"):
        assert f'extern "C" int oket_lstm_bwd_{entry}_f32(' in src


def test_f32_forward_source_is_3xtf32_on_the_tensor_cores():
    """Kernels 1 and 5 at f32 run the shared 3xTF32 gate loop (lstm_tf32.cuh:
    TMA ring, wgmma m64n128k8 TF32, A split in registers, in its form that
    folds each K chunk into an f32 sum) with the forward's epilogue; the FFMA
    gate product is no longer on their path."""
    src = (CSRC / "lstm_last_fwd_f32.cu").read_text()
    header = _tf32_gate_loop()
    assert '#include "lstm_tf32.cuh"' in src and '#include "lstm_f32.cuh"' not in src
    for call in ("tile_products<P, FOLD>(", "produce(", "tma_load_3d(", "setmaxnreg_inc<", "launch_split<false>("):
        assert call in src, call
    for call in ("tf32_split(", "wgmma_m64n128k8_tf32(", "mbar_wait("):
        assert call in header, call
    assert not re.search(r"\b(fmaf|fma4|gate_product_f32|load_gate_tile_f32)\(", src)
    for entry in ("oket_lstm_fwd_split_f32", "oket_lstm_last_step_f32"):
        assert f'extern "C" int {entry}(' in src


def test_f32_scan_source_is_3xtf32_on_the_tensor_cores():
    """Kernels 7 and 8 at f32 run the f32 kernels' 3xTF32 loop with D = 0
    (lstm_tf32.cuh: TMA ring, wgmma m64n128k8 TF32, A split in registers,
    each K chunk folded into an f32 sum): one function (scan_gate_tiles)
    gives kernel 7 and kernel 8's gate launch their products from zero,
    x_proj added after them in f32 and the measuring store of the gates;
    kernel 8's product launch is the fused f32 backward's (product_tiles),
    whose active-row count comes from the caller; one weight split a call.
    The FFMA kernels and lstm_f32.cuh are gone."""
    header = _tf32_gate_loop()
    src = (CSRC / "lstm_scan.cu").read_text()
    assert '#include "lstm_tf32.cuh"' in src and '#include "lstm_f32.cuh"' not in src
    assert not (CSRC / "lstm_f32.cuh").exists()
    for name in sorted(p.name for p in CSRC.iterdir()):
        assert "lstm_f32.cuh" not in (CSRC / name).read_text(), name
    f32 = src[src.index("namespace tf32 {"):src.index("}  // namespace tf32")]
    f32 += src[src.index('extern "C" int oket_lstm_scan_split_f32('):]
    for call in ("tile_products<", "produce(", "tma_load_3d(", "launch_split<", "setmaxnreg_inc<232>"):
        assert call in f32, call
    assert not re.search(r"\b(fmaf|fma4|gate_product_f32|launch_bwd_product_f32)\(", f32)
    loop = _body(f32, "scan_gate_tiles")
    for call in ("sum[i] = 0.f", "tile_products<P, true>(r, q, nk, wg, warp, lane, sum)",
                 "add_rows(xp, B, H, r0, u0, lane, n8, sum)", "store_gate_block(gates, B, H, r0, u0, lane, n8, sum)",
                 "epilogue(sum, r0, u0, lane, finish_gates)", "nk = t > 0 ? (H + TK - 1) / TK : 0",
                 "tma_load_3d(a, map_h, bar, kt * TK, row0, t - 1)"):
        assert call in loop, call
    # x_proj enters after the products and before the measuring store; no x or W_ih map at D = 0
    order = [loop.index(c) for c in ("tile_products<P, true>(", "add_rows(", "store_gate_block(", "epilogue(sum")]
    assert order == sorted(order)
    assert not re.search(r"map_x\b|map_wih|seed_bias|active_prefix", f32)
    for kernel in ("lstm_scan_step_kernel_tf32", "lstm_scan_bwd_gate_kernel_tf32"):
        body = _body(f32, kernel)
        assert "scan_gate_tiles<P, STORE>(&map_h, &map_whh_hi, &map_whh_lo, p.xp, p.gates, B, H, t," in body, kernel
        assert body.index("finish_gates(n8);") < body.index("sum[n8 * 4 + e]"), kernel
    assert "bwd_cell(" in _body(f32, "lstm_scan_bwd_gate_kernel_tf32")
    assert "product_tiles<P>(smem_raw, &map_dg, &map_wt_hi, &map_wt_lo, p, p.B)" in _body(
        f32, "lstm_scan_bwd_product_kernel_tf32")
    # the split: W_hh alone (w_ih null, D = 0), gate-major forward, and its transpose for the backward
    split = _body(src, "oket_lstm_scan_split_f32")
    assert "launch_split<true>(nullptr, w_hh, w_split, 0, H, stream)" in split
    assert "launch_split<false>(nullptr, w_hh, w_split, 0, H, stream)" in split
    # the f32 backward (kernels 2 and 6) runs the same product function, over the rows active at t
    prod = _body(header, "product_tiles")
    assert "tile_products<V, FOLD>(r, q, nk, wg, warp, lane, acc)" in prod and "n_act_all" in prod
    bwd = (CSRC / "lstm_last_bwd.cu").read_text()
    assert ("product_tiles<V, FOLD>(smem_raw, &map_dg, &map_wt_hi, &map_wt_lo, p, "
            "active_prefix<THREADS>(lens, p.B, p.t))") in _body(bwd, "lstm_bwd_product_kernel_tf32")
    for entry in ("split", "step", "bwd_gate", "bwd_product"):
        assert f'extern "C" int oket_lstm_scan_{entry}_f32(' in src
