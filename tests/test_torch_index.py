"""The port's index build and disk format against the JAX package:
builds bitwise equal, and an index saved by either loads in the other."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arxiv_rag_tpu.index.store import DenseIndex as JaxDenseIndex
from arxiv_rag_tpu.index.store import build_index as jax_build_index

from arxiv_rag_tpu_torch.index.store import DenseIndex, build_index


def _bits(values, dtype):
    """Raw bit patterns of either package's values, as numpy."""
    if isinstance(values, torch.Tensor):
        if dtype == "bfloat16":
            return values.view(torch.int16).numpy().view(np.uint16)
        return values.numpy()
    arr = np.asarray(values)
    return arr.view(np.uint16) if dtype == "bfloat16" else arr


@pytest.fixture(scope="module")
def embeddings():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((300, 48)).astype(np.float32) * 3.0
    x[7] = 0.0  # a zero row: normalization and quantization floors
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_build_index_bitwise_jax(embeddings, dtype):
    ids = [f"c{i}" for i in range(len(embeddings))]
    ours = build_index(embeddings, dtype=dtype, chunk_ids=ids)
    theirs = jax_build_index(embeddings, dtype=dtype, chunk_ids=ids)
    np.testing.assert_array_equal(_bits(ours.values, dtype), _bits(theirs.values, dtype))
    if dtype == "int8":
        np.testing.assert_array_equal(ours.scales.numpy(), np.asarray(theirs.scales))
    else:
        assert ours.scales is None and theirs.scales is None
    assert ours.chunk_ids == theirs.chunk_ids and ours.normalized == theirs.normalized


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_index_saved_by_either_loads_in_the_other(embeddings, dtype, tmp_path):
    ids = [f"c{i}" for i in range(len(embeddings))]
    cats = ["cs.LG" if i % 2 else "cs.CV" for i in range(len(embeddings))]
    ours = build_index(embeddings, dtype=dtype, chunk_ids=ids)
    ours.save(tmp_path / "port", rows_per_shard=128)  # several shards
    theirs = JaxDenseIndex.load(tmp_path / "port")
    np.testing.assert_array_equal(_bits(theirs.values, dtype), _bits(ours.values, dtype))
    assert theirs.dtype == dtype and theirs.chunk_ids == ids

    jax_idx = jax_build_index(embeddings, categories=cats, dtype=dtype, chunk_ids=ids)
    jax_idx.save(tmp_path / "jax", rows_per_shard=100)
    loaded = DenseIndex.load(tmp_path / "jax")
    np.testing.assert_array_equal(_bits(loaded.values, dtype), _bits(jax_idx.values, dtype))
    np.testing.assert_array_equal(loaded.row_masks, jax_idx.row_masks)
    assert loaded.categories == jax_idx.categories and loaded.chunk_ids == ids
    if dtype == "int8":
        np.testing.assert_array_equal(loaded.scales.numpy(), np.asarray(jax_idx.scales))
        np.testing.assert_array_equal(np.asarray(theirs.scales), ours.scales.numpy())


def test_build_index_from_tensor_matches_numpy(embeddings):
    """The device build (a tensor input, normalized in torch) agrees with
    the host build; sums differ in order only."""
    host = build_index(embeddings, dtype="float32")
    dev = build_index(torch.from_numpy(embeddings), dtype="float32")
    np.testing.assert_allclose(dev.values.numpy(), host.values.numpy(), atol=1e-6)
    q8 = build_index(torch.from_numpy(embeddings), dtype="int8")
    assert q8.values.dtype == torch.int8 and q8.scales.shape == (len(embeddings),)


def test_to_device_pads_rows_and_tracks_n_valid(embeddings):
    idx = build_index(embeddings, dtype="int8").to_device("cpu", row_multiple=256)
    assert idx._device_values.shape == (512, embeddings.shape[1])
    assert idx._n_valid == idx.num_rows == len(embeddings)
    assert (idx._device_values[len(embeddings):] == 0).all()
    assert (idx._device_scales[len(embeddings):] == 0).all()
    assert idx.values.data_ptr() == idx._device_values.data_ptr()  # held once


def test_bad_dtype_is_refused(embeddings):
    with pytest.raises(ValueError, match="index dtype"):
        build_index(embeddings, dtype="float16")
