"""Several processes (``parallel/distributed.py``) on the CPU under gloo,
against the port's in-process mesh and the JAX package.

The counterparts of ``tests/test_distributed_multiprocess.py`` (two real
processes through ``init_distributed``, ``host_shard``, a cross-process
collective; the embed → index → search slice at the reference's toy
widths) and of ``tests/test_sharded_search.py::
test_distributed_helpers_single_process``; then 2- and 4-process
sharded searches of every kind, the sharded IVF under both plans and the
sharded engine with a reload, each process holding only its own shards:

- against the port's in-process mesh of the same size
  (``DeviceMesh(["cpu"] * nd)``): bitwise, values and ids, on every
  rank, and the ranks bitwise each other;
- against JAX's ``sharded_topk(use_pallas=True, interpret=True)`` at the
  same nd: s8s8 (masked or not) bitwise; the float kinds with equal ids
  and scores within 1e-5 (fp32 sums in another order than the Pallas
  kernel, as tests/test_torch_sharded_search.py holds the in-process
  mesh).

Workers meet through a ``file://`` store under the test's directory
(one test keeps the reference's TCP address), take one thread each, and
every ``communicate`` has a timeout with a kill of any worker left
behind.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from arxiv_rag_tpu_torch.config import RetrievalConfig
from arxiv_rag_tpu_torch.index import build_index
from arxiv_rag_tpu_torch.index.ivf import IVFIndex
from arxiv_rag_tpu_torch.index.store import DenseIndex
from arxiv_rag_tpu_torch.ops.quant import quantize_int8
from arxiv_rag_tpu_torch.parallel import (
    DeviceMesh,
    ShardedIVF,
    global_mesh,
    host_shard,
    init_distributed,
    is_primary,
    shard_index_rows,
    sharded_topk,
)
from arxiv_rag_tpu_torch.search import SearchEngine

REPO = Path(__file__).resolve().parents[1]
N, D, Q, K = 4100, 64, 16, 10  # tests/test_torch_sharded_search.py's data
K_PLAIN = 200  # past the fused kernels' lists: the plain scan per shard
TOL = 1e-5
KINDS = ["f32", "bf16", "s8s8", "row", "masked f32", "masked bf16", "masked s8s8",
         "masked row"]
EXACT = ("s8s8", "masked s8s8")
NC, BR = 24, 128
IVF_CASES = [("host", 3, False), ("device", 3, False), ("host", NC, False),
             ("device", NC, False), ("host", 4, True)]
CATEGORIES = ["cs.LG", "cs.CV", "cs.AI"]
TIMEOUT_S = 240


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("ARAG_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "PYTHONPATH")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def run_workers(script: str, args_per_rank, env_per_rank=None, timeout=TIMEOUT_S):
    """Start one worker per rank (``python -c script *args``), wait for
    all, kill any left behind; returns each worker's last stdout line
    as JSON. A worker that exits non-zero fails the test with its
    stderr."""
    procs = []
    try:
        for r, args in enumerate(args_per_rank):
            env = _env()
            env.update((env_per_rank or {}).get(r, {}))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(REPO), *map(str, args)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


PRELUDE = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
from arxiv_rag_tpu_torch.parallel import (
    data_mesh, global_mesh, host_shard, init_distributed, is_primary)
"""


# -- the reference's two-process test: init, host_shard, a collective ---------

BASIC_WORKER = PRELUDE + r"""
import torch.distributed as dist
rank, addr = int(sys.argv[2]), sys.argv[3]
if rank == 0:  # the argument branch
    ok = init_distributed(coordinator_address=addr, num_processes=2, process_id=0,
                          device="cpu")
else:  # the env branch: ARAG_COORDINATOR, WORLD_SIZE and RANK
    ok = init_distributed(device="cpu")
assert ok, "init_distributed must initialize the process group"
assert init_distributed() is True  # a second call changes nothing
mesh = global_mesh()
# one entry per process: summing needs a real cross-process collective
total = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(total)
print(json.dumps({
    "rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend(),
    "mesh_devices": mesh.size, "local": list(mesh.local), "ranks": list(mesh.ranks),
    "data_mesh_is_global": data_mesh() == mesh,
    "shard": host_shard(list(range(10))), "primary": is_primary(),
    "psum_total": float(total),
}))
dist.destroy_process_group()
"""


def test_two_process_distributed():
    with socket.socket() as s:  # the reference's address path (its test :58)
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    outs = run_workers(BASIC_WORKER, [(0, addr), (1, addr)],
                       env_per_rank={1: {"ARAG_COORDINATOR": addr, "WORLD_SIZE": "2",
                                         "RANK": "1"}})
    by_rank = {o["rank"]: o for o in outs}
    assert set(by_rank) == {0, 1}
    for r, o in by_rank.items():
        assert o["world"] == 2 and o["backend"] == "gloo"
        assert o["mesh_devices"] == 2 and o["ranks"] == [0, 1] and o["local"] == [r]
        assert o["data_mesh_is_global"]
        assert o["psum_total"] == 3.0  # the collective saw both processes: 1 + 2
    assert by_rank[0]["primary"] is True and by_rank[1]["primary"] is False
    assert by_rank[0]["shard"] == [0, 2, 4, 6, 8]  # disjoint, covering, round-robin
    assert by_rank[1]["shard"] == [1, 3, 5, 7, 9]


def test_distributed_helpers_single_process(monkeypatch):
    """Without a configured group the helpers are no-ops, as the
    reference's (tests/test_sharded_search.py:73-84)."""
    for var in ("ARAG_COORDINATOR", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert is_primary()
    mesh = global_mesh(device="cpu")
    assert mesh.size == 1 and not mesh.spans_processes and mesh.local == (0,)
    items = list(range(10))
    assert host_shard(items) == items  # one process owns everything
    monkeypatch.setenv("WORLD_SIZE", "1")  # torchrun's variables alone, one process
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert init_distributed() is False


FAIL_WORKER = PRELUDE + r"""
import socket
import torch.distributed as dist
out = {}
with socket.socket() as s:  # a port nobody listens on
    s.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{s.getsockname()[1]}"
cases = {
    "unreachable": lambda: init_distributed(coordinator_address=dead, num_processes=2,
                                            process_id=1, device="cpu", timeout_s=3),
    "rank_out_of_range": lambda: init_distributed(coordinator_address=dead,
                                                  num_processes=2, process_id=2,
                                                  device="cpu"),
    "no_world_size": lambda: init_distributed(coordinator_address=dead, process_id=0,
                                              device="cpu"),
}
for name, call in cases.items():
    try:
        call()
        out[name] = "returned"
    except (RuntimeError, ValueError) as exc:
        out[name] = type(exc).__name__
    out[name + "_grouped"] = dist.is_initialized()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def failures():
    return run_workers(FAIL_WORKER, [()])[0]


@pytest.mark.parametrize("case,exc", [("unreachable", "RuntimeError"),
                                      ("rank_out_of_range", "ValueError"),
                                      ("no_world_size", "ValueError")])
def test_failed_initialization_raises(failures, case, exc):
    """A configured group that cannot start raises (the reference logs it
    and carries on as one process); no group is left behind."""
    assert failures[case] == exc
    assert failures[case + "_grouped"] is False


# -- the reference's embed -> index -> search slice, at its toy widths ---------

CFG_KW = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=64, max_position_embeddings=64)
E2E_WORKER = PRELUDE + r"""
from arxiv_rag_tpu_torch.embed import Embedder
from arxiv_rag_tpu_torch.models.mpnet import MPNet, ModelConfig
from arxiv_rag_tpu_torch.ops.topk import cosine_topk_numpy
from arxiv_rag_tpu_torch.parallel import shard_process_rows, sharded_topk
from arxiv_rag_tpu_torch.tokenize.wordpiece import WordPieceTokenizer

rank, store, weights = int(sys.argv[2]), sys.argv[3], sys.argv[4]
cfg_kw = json.loads(sys.argv[5])
assert init_distributed(init_method=f"file://{store}", num_processes=2, process_id=rank,
                        device="cpu")
WORDS = ["neural", "network", "training", "graph", "database", "query",
         "quantum", "physics", "protein", "folding", "image", "vision"]
rng = np.random.default_rng(7)
texts = [" ".join(rng.choice(WORDS, size=10)) + f" tag{i}" for i in range(64)]
tok = WordPieceTokenizer.toy()
cfg = ModelConfig(vocab_size=len(tok.vocab), **cfg_kw)
model = MPNet(cfg)
model.load_state_dict(torch.load(weights))
emb = Embedder(model.eval(), tok, buckets=(32,), batch_size=16)
my_rows = host_shard(list(range(len(texts))))  # this process embeds its share only
local = emb.encode_texts([texts[i] for i in my_rows])
mesh = global_mesh()
shards, n = shard_process_rows(local, mesh)  # rank 0's rows, then rank 1's
perm = list(range(0, len(texts), 2)) + list(range(1, len(texts), 2))
q_rows = [5, 17, 40, 63]
q = emb.encode_texts([texts[i] for i in q_rows])
vals, gids = sharded_topk(shards, torch.from_numpy(q), 5, mesh, n_valid=n)
full = emb.encode_texts(texts)  # the single-process oracle
ov, oi = cosine_topk_numpy(full, q, 5)
rows = [[perm[g] for g in r] for r in gids.tolist()]
print(json.dumps({"rank": rank, "n": n, "my_rows": my_rows, "local": local.tolist(),
                  "oracle_rows": oi.tolist(), "sharded_rows": rows,
                  "oracle_vals": ov.tolist(), "sharded_vals": vals.tolist(),
                  "self_top1": [r[0] for r in rows], "queries": q_rows}))
"""


def test_two_process_embed_index_search_parity(tmp_path):
    """Each process embeds its ``host_shard`` of 64 texts, the index is
    assembled from the process-local rows, and the sharded search returns
    the single-process oracle's rows (scores within the reference's
    1e-4), every query's own text first, the same on both ranks; each
    half's embeddings within 1e-5 of the JAX package's fp32 Embedder."""
    import jax
    import jax.numpy as jnp

    from arxiv_rag_tpu.embed import Embedder as JaxEmbedder
    from arxiv_rag_tpu.models import ModelConfig as JaxModelConfig
    from arxiv_rag_tpu.models import init_params
    from arxiv_rag_tpu.tokenize import WordPieceTokenizer as JaxTokenizer

    from arxiv_rag_tpu_torch.models.convert import from_jax_params
    from arxiv_rag_tpu_torch.models.mpnet import ModelConfig

    jtok = JaxTokenizer.toy()
    jcfg = JaxModelConfig(vocab_size=len(jtok.vocab), **CFG_KW)
    params = init_params(jax.random.PRNGKey(2), jcfg, dtype=jnp.float32)
    state = from_jax_params(jax.tree.map(np.asarray, params),
                            ModelConfig(vocab_size=len(jtok.vocab), **CFG_KW))
    torch.save(state, tmp_path / "weights.pt")
    outs = run_workers(E2E_WORKER, [(r, tmp_path / "store", tmp_path / "weights.pt",
                                     json.dumps(CFG_KW)) for r in range(2)])
    rng = np.random.default_rng(7)
    words = ["neural", "network", "training", "graph", "database", "query",
             "quantum", "physics", "protein", "folding", "image", "vision"]
    texts = [" ".join(rng.choice(words, size=10)) + f" tag{i}" for i in range(64)]
    want = JaxEmbedder(params, jcfg, jtok, buckets=(32,), batch_size=16,
                       compute_dtype=jnp.float32).encode_texts(texts)
    for o in outs:
        assert o["n"] == 64
        assert o["self_top1"] == o["queries"]
        assert o["sharded_rows"] == o["oracle_rows"]
        np.testing.assert_allclose(o["sharded_vals"], o["oracle_vals"], atol=1e-4)
        np.testing.assert_allclose(np.asarray(o["local"]), want[o["my_rows"]], atol=1e-5)
    assert outs[0]["sharded_rows"] == outs[1]["sharded_rows"]
    assert outs[0]["sharded_vals"] == outs[1]["sharded_vals"]


# -- sharded search across 2 and 4 processes -----------------------------------

SEARCH_WORKER = PRELUDE + r"""
from arxiv_rag_tpu_torch.config import RetrievalConfig
from arxiv_rag_tpu_torch.index.ivf import IVFIndex
from arxiv_rag_tpu_torch.index.store import DenseIndex
from arxiv_rag_tpu_torch.ops.quant import quantize_int8
from arxiv_rag_tpu_torch.parallel import ShardedIVF, shard_index_rows, sharded_topk
from arxiv_rag_tpu_torch.search import SearchEngine

rank, world, store, data_dir = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
assert init_distributed(init_method=f"file://{store}", num_processes=world, process_id=rank,
                        device="cpu")
d = np.load(f"{data_dir}/flat.npz")
mesh = global_mesh()
assert mesh.size == world and mesh.local == (rank,)
out = {}

def flat(kind, k):
    base = kind.removeprefix("masked ")
    kw = {}
    if base in ("s8s8", "row"):
        values, scales = quantize_int8(torch.from_numpy(d["index"]))
        kw.update(scales=shard_index_rows(scales, mesh)[0], int8_variant=base)
    else:
        values = torch.from_numpy(d["index"]).to(
            torch.bfloat16 if base == "bf16" else torch.float32)
    shards, n = shard_index_rows(values, mesh)
    assert [s is None for s in shards] == [r != rank for r in range(world)]
    if kind.startswith("masked"):
        kw.update(row_masks=shard_index_rows(d["row_masks"], mesh)[0],
                  query_mask=torch.from_numpy(d["qmask"]))
    return sharded_topk(shards, torch.from_numpy(d["queries"]), k, mesh, n_valid=n, **kw)

for kind in json.loads(sys.argv[6]):
    v, g = flat(kind, int(sys.argv[7]))
    out[f"flat {kind} v"], out[f"flat {kind} i"] = v.numpy(), g.numpy()
v, g = flat("bf16", int(sys.argv[8]))
out["plain v"], out["plain i"] = v.numpy(), g.numpy()

ivf_dir = f"{data_dir}/ivf"
dense = DenseIndex.load(ivf_dir)
ivf = IVFIndex.load(ivf_dir, dense, device="cpu")
siv = ShardedIVF.build(ivf, world)
queries = torch.from_numpy(np.load(f"{data_dir}/ivf_queries.npy"))
for plan, nprobe, masked in json.loads(sys.argv[9]):
    kw = {}
    if masked:
        kw["query_mask"] = np.full((queries.shape[0],), dense.category_mask(["cs.AI"]))
    v, r = siv.search(queries, 10, mesh, nprobe=nprobe, plan=plan, **kw)
    out[f"ivf {plan} {nprobe} {masked} v"], out[f"ivf {plan} {nprobe} {masked} r"] = v, r
assert [s is None for s in siv._device["shards"]] == [r != rank for r in range(world)]

# the engine over the saved index, sharded over the processes, then a reload
for nprobe in (0, 3):
    idx = DenseIndex.load(ivf_dir).to_device(mesh=mesh)
    eng = SearchEngine(idx, cfg=RetrievalConfig(nprobe=nprobe),
                       ivf=IVFIndex.load(ivf_dir, idx, device="cpu") if nprobe else None)
    for tag in ("before", "after"):
        for cats in (None, ["cs.AI"]):
            v, r = eng.search_embeddings(queries.numpy(), 10, categories=cats)
            key = f"engine {nprobe} {tag} {cats is not None}"
            out[key + " v"], out[key + " r"] = v, r
        if tag == "before":
            eng.prepare_reload(ivf_dir)()
            assert eng.index._mesh == mesh
            assert [s is None for s in eng.index._shard_values] == [
                r != rank for r in range(world)]
np.savez(f"{data_dir}/rank{rank}.npz", **out)
print(json.dumps({"rank": rank, "keys": len(out)}))
"""


def _normalize(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    """tests/test_torch_sharded_search.py's flat data and
    tests/test_torch_sharded_ivf.py's blobs (a category per row)."""
    rng = np.random.default_rng(11)
    index = _normalize(rng.standard_normal((N, D), dtype=np.float32))
    queries = _normalize(rng.standard_normal((Q, D), dtype=np.float32))
    codes = rng.integers(0, 32, N).astype(np.uint32)
    row_masks = (np.uint32(1) << codes).view(np.int32)
    qmask = rng.integers(1, 2**32, Q, dtype=np.uint64).astype(np.uint32)
    qmask[0] = 0
    qmask[1] = np.uint32(1 << 31)
    qmask[2] = np.uint32(0xFFFFFFFF)
    rng = np.random.default_rng(13)
    centers = _normalize(rng.standard_normal((NC, D)).astype(np.float32))
    rows = centers[np.repeat(np.arange(NC), 100)]
    rows = _normalize(rows + 0.05 * rng.standard_normal(rows.shape).astype(np.float32))
    rows = rows[rng.permutation(rows.shape[0])]
    ivf_q = _normalize(rows[rng.choice(rows.shape[0], 24)]
                       + 0.1 * rng.standard_normal((24, D)).astype(np.float32))
    cats = list(rng.choice(CATEGORIES, size=rows.shape[0]))
    return {"flat": (index, queries, row_masks, qmask.view(np.int32)),
            "ivf": (rows, ivf_q, cats)}


def _saved(tmp, data):
    index, queries, row_masks, qmask = data["flat"]
    np.savez(tmp / "flat.npz", index=index, queries=queries, row_masks=row_masks, qmask=qmask)
    rows, ivf_q, cats = data["ivf"]
    dense = build_index(rows, dtype="int8", categories=cats)
    dense.save(tmp / "ivf")
    IVFIndex.build(dense, NC, block_rows=BR, iters=4, device="cpu").save(tmp / "ivf")
    np.save(tmp / "ivf_queries.npy", ivf_q)


@pytest.fixture(scope="module", params=[2, 4], ids=["2proc", "4proc"])
def ranks(request, data, tmp_path_factory):
    """Every rank's results of one run of ``request.param`` processes."""
    nd = request.param
    tmp = tmp_path_factory.mktemp(f"dist{nd}")
    _saved(tmp, data)
    outs = run_workers(SEARCH_WORKER, [
        (r, nd, tmp / "store", tmp, json.dumps(KINDS), K, K_PLAIN, json.dumps(IVF_CASES))
        for r in range(nd)])
    assert sorted(o["rank"] for o in outs) == list(range(nd))
    results = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(nd)]
    return nd, tmp, results


def _in_process(kind, nd, flat, k=K):
    """The same search on the in-process mesh of nd entries."""
    index, queries, row_masks, qmask = flat
    mesh = DeviceMesh(["cpu"] * nd)
    base = kind.removeprefix("masked ")
    kw = {}
    if base in ("s8s8", "row"):
        values, scales = quantize_int8(torch.from_numpy(index))
        kw.update(scales=shard_index_rows(scales, mesh)[0], int8_variant=base)
    else:
        values = torch.from_numpy(index).to(torch.bfloat16 if base == "bf16" else torch.float32)
    shards, n = shard_index_rows(values, mesh)
    if kind.startswith("masked"):
        kw.update(row_masks=shard_index_rows(row_masks, mesh)[0],
                  query_mask=torch.from_numpy(qmask))
    v, g = sharded_topk(shards, torch.from_numpy(queries), k, mesh, n_valid=n, **kw)
    return v.numpy(), g.numpy()


def _bitwise_on_every_rank(results, key, want):
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res[key], want, err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("kind", KINDS + ["bf16 k=200"])
def test_cross_process_flat_is_the_in_process_mesh(ranks, data, kind):
    """Every kind over nd processes: bitwise the in-process mesh of nd
    entries, values and ids, on every rank."""
    nd, _, results = ranks
    if kind == "bf16 k=200":
        v, g = _in_process("bf16", nd, data["flat"], K_PLAIN)
        keys = ("plain v", "plain i")
    else:
        v, g = _in_process(kind, nd, data["flat"])
        keys = (f"flat {kind} v", f"flat {kind} i")
    _bitwise_on_every_rank(results, keys[0], v)
    _bitwise_on_every_rank(results, keys[1], g)
    assert g.max() < N


_JAX: dict = {}


@pytest.mark.parametrize("kind", KINDS)
def test_cross_process_flat_matches_jax(ranks, data, kind):
    """Every kind over nd processes against JAX's sharded Pallas route on
    nd of its 8 CPU devices: s8s8 bitwise, the float kinds with equal ids
    and scores within 1e-5."""
    import jax.numpy as jnp

    from arxiv_rag_tpu.ops.quant import quantize_int8 as jax_quantize_int8
    from arxiv_rag_tpu.parallel import data_mesh as jax_data_mesh
    from arxiv_rag_tpu.parallel import shard_index_rows as jax_shard_index_rows
    from arxiv_rag_tpu.parallel import sharded_topk as jax_sharded_topk

    nd, _, results = ranks
    index, queries, row_masks, qmask = data["flat"]
    mesh = jax_data_mesh(nd)
    base = kind.removeprefix("masked ")
    kw = {}
    if base in ("s8s8", "row"):
        jq, js = jax_quantize_int8(jnp.asarray(index))
        values = np.asarray(jq)
        s, _ = jax_shard_index_rows(np.asarray(js).reshape(-1, 1), mesh)
        kw.update(scales=s.reshape(-1), int8_variant=base)
    else:
        values = np.asarray(jnp.asarray(index, jnp.bfloat16 if base == "bf16" else jnp.float32))
    shards, n = jax_shard_index_rows(values, mesh)
    if kind.startswith("masked"):
        rm, _ = jax_shard_index_rows(row_masks.reshape(-1, 1), mesh)
        kw.update(row_masks=rm.reshape(-1), query_mask=jnp.asarray(qmask))
    jv, jg = jax_sharded_topk(shards, jnp.asarray(queries), K, mesh, n_valid=n,
                              use_pallas=True, interpret=True, **kw)
    for res in results:
        np.testing.assert_array_equal(res[f"flat {kind} i"], np.asarray(jg))
        np.testing.assert_allclose(res[f"flat {kind} v"], np.asarray(jv),
                                   atol=0 if kind in EXACT else TOL)


@pytest.mark.parametrize("plan,nprobe,masked", IVF_CASES)
def test_cross_process_ivf_is_the_in_process_mesh(ranks, plan, nprobe, masked):
    """``ShardedIVF`` over nd processes, each placing and scanning its own
    shards: bitwise the in-process mesh's, on every rank."""
    nd, tmp, results = ranks
    dense = DenseIndex.load(tmp / "ivf")
    ivf = IVFIndex.load(tmp / "ivf", dense, device="cpu")
    queries = torch.from_numpy(np.load(tmp / "ivf_queries.npy"))
    kw = {}
    if masked:
        kw["query_mask"] = np.full((queries.shape[0],), dense.category_mask(["cs.AI"]))
    v, r = ShardedIVF.build(ivf, nd).search(queries, 10, DeviceMesh(["cpu"] * nd),
                                           nprobe=nprobe, plan=plan, **kw)
    _bitwise_on_every_rank(results, f"ivf {plan} {nprobe} {masked} v", v)
    _bitwise_on_every_rank(results, f"ivf {plan} {nprobe} {masked} r", r)


@pytest.mark.parametrize("nprobe", [0, 3])
def test_cross_process_engine_and_reload(ranks, nprobe):
    """A ``SearchEngine`` over an index sharded across the processes
    (dense int8, with and without categories; the IVF device plan at
    nprobe 3) answers as one over the in-process mesh, before and after a
    reload that re-places each process's own shards."""
    nd, tmp, results = ranks
    idx = DenseIndex.load(tmp / "ivf").to_device(mesh=DeviceMesh(["cpu"] * nd))
    eng = SearchEngine(idx, cfg=RetrievalConfig(nprobe=nprobe),
                       ivf=IVFIndex.load(tmp / "ivf", idx, device="cpu") if nprobe else None)
    queries = np.load(tmp / "ivf_queries.npy")
    for cats in (None, ["cs.AI"]):
        v, r = eng.search_embeddings(queries, 10, categories=cats)
        for tag in ("before", "after"):
            key = f"engine {nprobe} {tag} {cats is not None}"
            _bitwise_on_every_rank(results, key + " v", v)
            _bitwise_on_every_rank(results, key + " r", r)
