"""The W8A8 kernel's launch plan and shared-memory layouts, on the CPU.

``ops/w8a8.py::plan`` picks the form, ring stages and N tiles per block
of ``csrc/w8a8.cu::w8a8_kernel`` from the shape alone; these tests hold
it to the card's limits (232,448 bytes of shared memory a block and 132
SMs on an H100). The layout models replay, in numpy, where the kernel's
quantizer writes a K slice of A, where wgmma's K-major 128-byte-swizzled
descriptor reads it, where TMA's 128-byte swizzle puts K7's x_q slice,
and where the epilogue puts an output box and copies it out by rows:
each must recover its matrix byte for byte. The quantized values come
from ``quantize_activations``, which tests/test_torch_w8a8.py holds
bitwise against the JAX package."""

import numpy as np
import pytest
import torch

from arxiv_rag_tpu_torch.ops import w8a8

ENCODER = [(m, k, n) for m in (8192, 65536) for k, n in ((768, 768), (768, 3072), (3072, 768))]
SPAN = 128  # bytes of a row per K slice (one swizzle span)


@pytest.mark.parametrize("quantize", [True, False])
def test_plan_fits_the_card_for_every_k(quantize):
    """Every K % 16 == 0 up to the old K8 limit of 6,272 (and past it) gets
    a plan whose block fits the H100's 232,448 bytes, with at least two
    ring stages; K8 keeps its rows resident exactly while they fit."""
    for k in range(16, 8193, 16):
        p = w8a8.plan(4096, 768, k, quantize)
        assert p.smem <= w8a8.H100_SMEM, (k, p)
        assert p.smem == w8a8.smem_bytes(p.form, p.stages, k)
        assert 2 <= p.stages <= 4
        resident_fits = w8a8.smem_bytes(w8a8.RESIDENT, 2, k) <= w8a8.H100_SMEM
        assert p.form == (w8a8.RESIDENT if quantize and resident_fits else w8a8.STREAMED)
        assert p.stages == 4 or w8a8.smem_bytes(p.form, p.stages + 1, k) > w8a8.H100_SMEM


@pytest.mark.parametrize("m,k,n", ENCODER)
@pytest.mark.parametrize("quantize", [True, False])
def test_plan_at_the_encoder_shapes(m, k, n, quantize):
    p = w8a8.plan(m, n, k, quantize)
    assert p.smem <= w8a8.H100_SMEM
    n_tiles = -(-n // 256)
    assert p.grid == (-(-n_tiles // p.tiles_per_block), -(-m // 128))
    # every N tile is covered once
    assert p.grid[0] * p.tiles_per_block >= n_tiles > (p.grid[0] - 1) * p.tiles_per_block
    if m == 8192:  # the card is filled: N split among blocks where rows are few
        assert p.blocks >= w8a8.H100_SMS
    if quantize and m == 65536:  # one row-scale pass per row block
        assert p.tiles_per_block == n_tiles
    if quantize:
        assert p.form == (w8a8.RESIDENT if k == 768 else w8a8.STREAMED)
    else:
        assert p.form == w8a8.STREAMED and p.tiles_per_block == 1


def test_plan_splits_n_only_where_row_blocks_are_few():
    assert w8a8.plan(65536, 3072, 768, True).grid == (1, 512)
    assert w8a8.plan(8192, 3072, 768, True).grid == (3, 64)
    assert w8a8.plan(1, 200, 752, True).grid == (1, 1)
    assert w8a8.plan(17000, 768, 768, True).grid == (1, 133)  # 133 row blocks >= 132 SMs
    assert w8a8.plan(16384, 768, 768, True, sms=200).grid == (2, 128)  # the card's SM count


def _sw128(offset: np.ndarray) -> np.ndarray:
    """The 128-byte swizzle of TMA and wgmma inside a 1024-byte-aligned
    tile: the 16-byte chunk bits [4:6] XORed with the row bits [7:9]."""
    return offset ^ (((offset >> 7) & 7) << 4)


def _descriptor_read(tile: np.ndarray, rows: int) -> np.ndarray:
    """What wgmma reads through ``sw128_desc`` (K-major, 128-byte swizzle,
    8-row groups 1024 bytes apart) from a tile of ``rows`` x 128 bytes:
    the four 32-byte k-steps at start offsets 0, 32, 64 and 96, each
    [rows, 32], put side by side."""
    r = np.arange(rows)[:, None]
    steps = []
    for kk in range(4):
        kb = kk * 32 + np.arange(32)[None, :]
        addr = (r // 8) * 1024 + (r % 8) * 128 + (((kb // 16) ^ (r % 8)) * 16) + kb % 16
        steps.append(tile[addr])
    return np.concatenate(steps, axis=1)


def _quantizer_writes(x_q_slice: np.ndarray) -> np.ndarray:
    """A warpgroup's 64-row A slice as ``quantize_chunks`` writes it:
    thread t takes the 16-byte chunk c = t & 7 of rows (t >> 3) + 16j and
    stores it at row r, chunk c ^ (r & 7)."""
    tile = np.full(64 * SPAN, 0xAA, np.uint8)  # poison: every byte must be written
    for t in range(128):
        c, r0 = t & 7, t >> 3
        for j in range(4):
            r = r0 + 16 * j
            at = r * SPAN + ((c ^ (r & 7)) << 4)
            tile[at:at + 16] = x_q_slice[r, 16 * c:16 * c + 16]
    return tile


@pytest.mark.parametrize("k", [768, 752, 3072])
def test_quantizer_layout_is_what_the_descriptor_reads(k):
    """The quantized rows written into the swizzled A slices come back byte
    for byte through the descriptor's K-major reading, slice by slice and
    k-step by k-step (a K of 16 mod 32 reads zeros past K), and equal
    what TMA's 128-byte swizzle gives K7 from x_q in device memory."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy((rng.normal(0, 1, (64, k)) * rng.uniform(0.01, 10, (64, 1))).astype(
        np.float32)).to(torch.bfloat16)
    x[5] = 0  # an all-zero row
    x_q = w8a8.quantize_activations(x)[0].numpy().view(np.uint8)
    slices = -(-k // SPAN)
    padded = np.zeros((64, slices * SPAN), np.uint8)
    padded[:, :k] = x_q
    read = []
    for s in range(slices):
        part = padded[:, s * SPAN:(s + 1) * SPAN]
        tile = _quantizer_writes(part)
        # TMA: row-major box bytes at their swizzled offsets
        tma = np.empty_like(tile)
        tma[_sw128(np.arange(64 * SPAN))] = part.reshape(-1)
        np.testing.assert_array_equal(tile, tma)
        read.append(_descriptor_read(tile, 64))
    np.testing.assert_array_equal(np.concatenate(read, axis=1)[:, :k], x_q)
    assert (np.concatenate(read, axis=1)[:, k:] == 0).all()


@pytest.mark.parametrize("ob", [2, 4])
def test_epilogue_box_is_what_the_copy_out_reads(ob):
    """The epilogue's fragment writes (warp wi, lane (g, t4): rows 16wi + g
    + 8h, columns 8ii + 2t4 + {0, 1} of a box of 128 bytes a row, chunk
    c of row r at c ^ (r & 7)) and the copy-out's reads (thread t: chunk
    t & 7 of rows (t >> 3) + 16j, at the same swizzled place) give back
    the 64 x (128 / ob) output block in row-major order, every byte
    written and read once; the box is the 128-byte swizzle's layout."""
    cols = SPAN // ob
    out = np.random.default_rng(ob).integers(0, 256, (64, SPAN), dtype=np.uint8)
    box = np.full(64 * SPAN, 0x55, np.uint8)
    for wi in range(4):
        for lane in range(32):
            g, t4 = lane >> 2, lane & 3
            for ii in range(cols // 8):
                for h in range(2):
                    r = 16 * wi + g + 8 * h
                    byte = (8 * ii + 2 * t4) * ob
                    at = r * SPAN + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15))
                    box[at:at + 2 * ob] = out[r, byte:byte + 2 * ob]
    np.testing.assert_array_equal(box[_sw128(np.arange(64 * SPAN))].reshape(64, SPAN), out)
    copied = np.full((64, SPAN), 0x55, np.uint8)
    for t in range(128):
        c = t & 7
        for j in range(4):
            r = (t >> 3) + 16 * j
            at = r * SPAN + ((c ^ (r & 7)) << 4)
            copied[r, 16 * c:16 * c + 16] = box[at:at + 16]
    np.testing.assert_array_equal(copied, out)


def test_w8a8_variants_still_apply_to_the_kernel_source():
    """``w8a8_variants.py`` makes its variants by editing the text of
    ``csrc/w8a8.cu``: every anchor is still there, and every variant but
    the first differs from the source."""
    from arxiv_rag_tpu_torch import w8a8_variants
    from arxiv_rag_tpu_torch.ops import _build

    src = (_build.CSRC / "w8a8.cu").read_text()
    made = w8a8_variants.variants(src)
    assert made.pop("as_is") == src
    for name, text in made.items():
        assert text != src, name
