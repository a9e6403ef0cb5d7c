"""Index growth in the port against the JAX package: ``append_index``
(bitwise JAX's and bitwise a full build, as tests/test_index_append.py
holds the reference to) and ``IVFIndex.extend`` (the perm and offsets of
a full build with the same centroids, and of JAX's extend)."""

import json

import numpy as np
import pytest
import torch

from arxiv_rag_tpu.index.ivf import IVFIndex as JaxIVFIndex
from arxiv_rag_tpu.index.store import DenseIndex as JaxDenseIndex
from arxiv_rag_tpu.index.store import append_index as jax_append_index
from arxiv_rag_tpu.index.store import build_index as jax_build_index
from arxiv_rag_tpu.ops.kmeans import spherical_kmeans as jax_spherical_kmeans

from arxiv_rag_tpu_torch.index.ivf import IVFIndex
from arxiv_rag_tpu_torch.index.store import (
    DenseIndex,
    append_index,
    build_index,
    build_index_device,
)
from arxiv_rag_tpu_torch.ops.topk import flat_search

D = 48
N = 150
SPLIT = 90  # base rows; the rest are appended


def _emb(n, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32) * 2.0


def _blobs(n, d=32, c=8, seed=1):
    """Rows near one of ``c`` centres, so nearest-centroid ties never
    decide an assignment."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((c, d)).astype(np.float32)
    x = centres[rng.integers(0, c, n)] + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
    return x


def _bits(values, dtype):
    """Raw bit patterns of either package's values, as numpy."""
    if isinstance(values, torch.Tensor):
        values = values.cpu()
        return values.view(torch.int16).numpy() if dtype == "bfloat16" else values.numpy()
    arr = np.asarray(values)
    return arr.view(np.int16) if dtype == "bfloat16" else arr


def _scales(idx):
    return None if idx.scales is None else np.asarray(
        idx.scales.cpu() if isinstance(idx.scales, torch.Tensor) else idx.scales)


def assert_same_index(a, b, dtype):
    """Values, scales, row masks, categories and chunk ids bit for bit."""
    np.testing.assert_array_equal(_bits(a.values, dtype), _bits(b.values, dtype))
    sa, sb = _scales(a), _scales(b)
    assert (sa is None) == (sb is None)
    if sa is not None:
        np.testing.assert_array_equal(sa, sb)
    assert (a.row_masks is None) == (b.row_masks is None)
    if a.row_masks is not None:
        np.testing.assert_array_equal(np.asarray(a.row_masks), np.asarray(b.row_masks))
    assert list(a.categories) == list(b.categories)
    assert a.chunk_ids == b.chunk_ids


@pytest.fixture(scope="module")
def corpus():
    full = _emb(N)
    full[5] = 0.0  # a zero row: the normalization and scale floors
    cats = ["cs.LG"] * 40 + ["cs.CV"] * 50 + ["cs.AI"] * 40 + ["q-bio"] * 20
    ids = [f"c{i:03d}" for i in range(N)]
    return full, cats, ids


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_append_matches_jax_and_a_full_build(corpus, dtype, tmp_path):
    full, cats, ids = corpus
    base = build_index(full[:SPLIT], categories=cats[:SPLIT], dtype=dtype,
                       chunk_ids=ids[:SPLIT])
    base.save(tmp_path / "port", rows_per_shard=32)
    jax_build_index(full[:SPLIT], categories=cats[:SPLIT], dtype=dtype,
                    chunk_ids=ids[:SPLIT]).save(tmp_path / "jax", rows_per_shard=32)
    ours = append_index(tmp_path / "port", full[SPLIT:], categories=cats[SPLIT:],
                        chunk_ids=ids[SPLIT:], rows_per_shard=32, device="cpu")
    theirs = jax_append_index(tmp_path / "jax", full[SPLIT:], categories=cats[SPLIT:],
                              chunk_ids=ids[SPLIT:], rows_per_shard=32)
    # old categories keep their bits; the new ones append in sorted order
    assert ours.categories == ["cs.CV", "cs.LG", "cs.AI", "q-bio"] == theirs.categories
    assert ours.num_rows == N and ours.values.device.type == "cpu"
    assert_same_index(ours, theirs, dtype)
    oracle = build_index(full, categories=cats, category_names=ours.categories, dtype=dtype,
                         chunk_ids=ids)
    assert_same_index(ours, oracle, dtype)
    # the same files: new shards numbered after the old, offsets continuing
    m_ours = json.loads((tmp_path / "port/index.json").read_text())
    m_theirs = json.loads((tmp_path / "jax/index.json").read_text())
    for m in (m_ours, m_theirs):
        m.pop("created_at")
    assert m_ours == m_theirs
    assert [s["row_offset"] for s in m_ours["shards"]] == [0, 32, 64, 90, 122]
    for s in m_ours["shards"]:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / s["file"]),
                                      np.load(tmp_path / "jax" / s["file"]))


def test_append_multiple_rounds(tmp_path):
    full = _emb(90, seed=3)
    build_index(full[:30], dtype="bfloat16").save(tmp_path, rows_per_shard=16)
    append_index(tmp_path, full[30:55], rows_per_shard=16, device="cpu")
    combined = append_index(tmp_path, torch.from_numpy(full[55:]), rows_per_shard=16,
                            device="cpu")
    assert_same_index(combined, build_index(full, dtype="bfloat16"), "bfloat16")
    assert_same_index(combined, JaxDenseIndex.load(tmp_path), "bfloat16")
    manifest = json.loads((tmp_path / "index.json").read_text())
    offs = [s["row_offset"] for s in manifest["shards"]]
    assert offs == sorted(offs) and manifest["num_rows"] == 90
    assert (tmp_path / "embeddings-00005.npy").exists()  # 2 + 2 + 3 shards, none rewritten


@pytest.mark.parametrize("package", ["port", "jax"])
def test_append_validation_errors(tmp_path, package):
    """The port refuses what the reference refuses, with its messages."""
    build, append = ((build_index, lambda *a, **k: append_index(*a, device="cpu", **k))
                     if package == "port" else (jax_build_index, jax_append_index))
    build(_emb(20), categories=["cs.LG"] * 20, dtype="int8",
          chunk_ids=[f"c{i}" for i in range(20)]).save(tmp_path)
    with pytest.raises(ValueError, match="dim"):
        append(tmp_path, _emb(4, d=32), categories=["cs.LG"] * 4, chunk_ids=list("abcd"))
    with pytest.raises(ValueError, match="category parity"):
        append(tmp_path, _emb(4), chunk_ids=list("abcd"))
    with pytest.raises(ValueError, match="chunk-id parity"):
        append(tmp_path, _emb(4), categories=["cs.LG"] * 4)
    with pytest.raises(ValueError, match="2 chunk_ids for 4 appended rows"):
        append(tmp_path, _emb(4), categories=["cs.LG"] * 4, chunk_ids=list("ab"))
    with pytest.raises(ValueError, match="3 categories for 4 appended rows"):
        append(tmp_path, _emb(4), categories=["cs.LG"] * 3, chunk_ids=list("abcd"))
    with pytest.raises(ValueError, match="more than 32 categories"):
        append(tmp_path, _emb(40), categories=[f"c{i}" for i in range(40)],
               chunk_ids=[f"n{i}" for i in range(40)])
    assert DenseIndex.load(tmp_path).num_rows == 20  # every refusal left it as it was
    build(_emb(10), dtype="bfloat16").save(tmp_path / "plain")
    with pytest.raises(ValueError, match="category parity"):
        append(tmp_path / "plain", _emb(4), categories=["cs.LG"] * 4)


def test_category_31_takes_the_sign_bit(tmp_path):
    """A category appended at bit 31 sets the int32 sign bit of the masks
    on the device, and filters exactly."""
    x = _emb(64)
    names = [f"cat{i:02d}" for i in range(31)]
    build_index(x[:62], categories=[names[i % 31] for i in range(62)],
                dtype="int8").save(tmp_path)
    grown = append_index(tmp_path, x[62:], categories=["zzz", "cat03"], device="cpu")
    assert grown.categories.index("zzz") == 31
    assert grown.row_masks[62] == np.uint32(1 << 31)
    grown.to_device("cpu")
    assert int(grown._device_masks[62]) == -(1 << 31)
    assert grown.category_mask(["zzz"]) == np.uint32(1 << 31)


def test_longer_sidecars_are_trimmed(tmp_path):
    """An append cut between its sidecars and its manifest leaves longer
    sidecars: ``load`` trims them, and the next append extends the base
    rows, not the stale tail (the reference would append after it)."""
    x = _emb(40)
    cats = ["cs.LG"] * 20 + ["cs.CV"] * 20
    ids = [f"c{i}" for i in range(40)]
    base = build_index(x[:24], categories=cats[:24], dtype="int8", chunk_ids=ids[:24])
    base.save(tmp_path)
    np.save(tmp_path / "scales.npy", np.concatenate([base.scales.numpy(), np.ones(8, np.float32)]))
    np.save(tmp_path / "row_masks.npy",
            np.concatenate([base.row_masks, np.full(8, 7, np.uint32)]))
    (tmp_path / "chunk_ids.json").write_text(json.dumps(ids[:24] + ["stale"] * 8))
    for load in (DenseIndex.load, JaxDenseIndex.load):
        loaded = load(tmp_path)
        assert loaded.num_rows == 24 and len(loaded.chunk_ids) == 24
        assert loaded.scales.shape == (24,) and loaded.row_masks.shape == (24,)
    grown = append_index(tmp_path, x[24:], categories=cats[24:], chunk_ids=ids[24:],
                         device="cpu")
    assert_same_index(grown, build_index(x, categories=cats, category_names=grown.categories,
                                         dtype="int8", chunk_ids=ids), "int8")


def test_an_index_grown_by_either_package_loads_in_the_other(corpus, tmp_path):
    """The port appends to a JAX-saved index, JAX appends to that, and the
    port appends again: each step loads in both packages, bitwise a
    full build."""
    full, cats, ids = corpus
    jax_build_index(full[:50], categories=cats[:50], dtype="int8",
                    chunk_ids=ids[:50]).save(tmp_path, rows_per_shard=20)
    append_index(tmp_path, full[50:90], categories=cats[50:90], chunk_ids=ids[50:90],
                 rows_per_shard=20, device="cpu")
    jax_append_index(tmp_path, full[90:120], categories=cats[90:120], chunk_ids=ids[90:120],
                     rows_per_shard=20)
    grown = append_index(tmp_path, full[120:], categories=cats[120:], chunk_ids=ids[120:],
                         rows_per_shard=20, device="cpu")
    oracle = build_index(full, categories=cats, category_names=grown.categories,
                         dtype="int8", chunk_ids=ids)
    assert_same_index(grown, oracle, "int8")
    assert_same_index(JaxDenseIndex.load(tmp_path), oracle, "int8")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_build_index_device_is_the_tensor_build_in_batches(corpus, dtype):
    """Row batches give the bits of one tensor build of all rows (each row
    is normalized and quantized on its own); numpy or tensor input."""
    full, cats, ids = corpus
    whole = build_index(torch.from_numpy(full), categories=cats, dtype=dtype, chunk_ids=ids)
    for data in (full, torch.from_numpy(full)):
        batched = build_index_device(data, categories=cats, dtype=dtype, chunk_ids=ids,
                                     batch_rows=37, device="cpu")
        assert_same_index(batched, whole, dtype)
    empty = build_index_device(full[:0], dtype=dtype, device="cpu")
    assert empty.num_rows == 0 and empty.dim == D
    with pytest.raises(ValueError, match="dtype"):
        build_index_device(full, dtype="float16", device="cpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_every_build_path_is_the_reference_host_build(corpus, dtype):
    """Normalized, the tensor path and the batched device path (numpy or
    tensor input) are bitwise the JAX package's host build in values and
    scales: each takes its row norms from numpy and divides by a tensor.
    A second run at 768 wide rows, where numpy's pairwise sum and
    ``torch.linalg.vector_norm`` part more often, holds the same."""
    full, cats, ids = corpus
    wide = _emb(64, d=768, seed=5)
    for x, c, i in ((full, cats, ids), (wide, None, None)):
        want = jax_build_index(x, categories=c, dtype=dtype, chunk_ids=i)
        for got in (build_index(torch.from_numpy(x), categories=c, dtype=dtype, chunk_ids=i),
                    build_index_device(x, categories=c, dtype=dtype, chunk_ids=i,
                                       batch_rows=23, device="cpu"),
                    build_index_device(torch.from_numpy(x), categories=c, dtype=dtype,
                                       chunk_ids=i, batch_rows=23, device="cpu")):
            assert_same_index(got, want, dtype)


# -- IVFIndex.extend ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ivf_data():
    x = _blobs(400)
    cents = jax_spherical_kmeans(x[:250] / np.linalg.norm(x[:250], axis=1, keepdims=True),
                                 8, iters=4, seed=0, sample_rows=None)
    return x, np.asarray(cents)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_ivf_extend_matches_a_full_build_and_jax(ivf_data, dtype, tmp_path):
    x, cents = ivf_data
    for d, build, ivf_cls in ((tmp_path / "port", build_index, IVFIndex),
                              (tmp_path / "jax", jax_build_index, JaxIVFIndex)):
        base = build(x[:250], dtype=dtype)
        base.save(d, rows_per_shard=128)
        kw = {"device": "cpu"} if ivf_cls is IVFIndex else {}
        ivf_cls.build(base, 8, block_rows=8, centroids=cents, **kw).save(d)
    combined = append_index(tmp_path / "port", x[250:], rows_per_shard=128, device="cpu")
    ours = IVFIndex.extend(tmp_path / "port", combined, assign_batch=96, device="cpu")
    jcombined = jax_append_index(tmp_path / "jax", x[250:], rows_per_shard=128)
    theirs = JaxIVFIndex.extend(tmp_path / "jax", jcombined)
    oracle = IVFIndex.build(combined, 8, block_rows=8, centroids=cents, device="cpu")
    for other in (oracle, theirs):
        np.testing.assert_array_equal(ours.perm, other.perm)
        np.testing.assert_array_equal(ours.offsets, other.offsets)
    assert ours.n_valid == 400 and ours.dead_block == oracle.dead_block
    np.testing.assert_array_equal(_bits(ours.values, dtype), _bits(oracle.values, dtype))
    # the refreshed delta is on disk: it loads in both packages
    reloaded = IVFIndex.load(tmp_path / "port", combined, device="cpu")
    jreloaded = JaxIVFIndex.load(tmp_path / "port", JaxDenseIndex.load(tmp_path / "port"))
    np.testing.assert_array_equal(reloaded.perm, jreloaded.perm)
    np.testing.assert_array_equal(reloaded.centroids, cents)
    # at full probe the extended delta finds the flat scan's rows
    q = _blobs(16, seed=9)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _, rows = reloaded.search(q, 5, nprobe=8)
    dense = combined.values.to(torch.float32)
    if dtype == "int8":
        dense = dense * combined.scales[:, None]
    _, flat = flat_search(dense, torch.from_numpy(q).to(torch.bfloat16).to(torch.float32), 5)
    np.testing.assert_array_equal(np.sort(rows, axis=1), np.sort(flat.numpy(), axis=1))


@pytest.mark.parametrize("package", ["port", "jax"])
def test_ivf_extend_guards(tmp_path, package):
    b, ivf_cls, kw = ((build_index, IVFIndex, {"device": "cpu"}) if package == "port"
                      else (jax_build_index, JaxIVFIndex, {}))
    base = b(_blobs(64), dtype="bfloat16")
    base.save(tmp_path)
    ivf_cls.build(base, 4, block_rows=8, iters=2, **kw).save(tmp_path)
    with pytest.raises(ValueError, match="shrank"):
        ivf_cls.extend(tmp_path, b(_blobs(32), dtype="bfloat16"), **kw)
    with pytest.raises(ValueError, match="dtype"):
        ivf_cls.extend(tmp_path, b(_blobs(64), dtype="int8"), **kw)
