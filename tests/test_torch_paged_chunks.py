"""K8/K8q at prefill-chunk query counts (Tq 32, 128, 512), on the CPU.

A prefill chunk runs the paged kernel with ``Tq`` = the chunk width, and
the kernel takes the queries in tiles of ``KERNEL_QUERY_TILE``.  No card
runs here, so three things are pinned on the CPU:

- the plain path: ``paged_chunk_attention`` on CPU tensors (f32 K/V, and
  int8 K/V with scales), chunk-causal, with and without pool pages, held
  against the JAX package's ``paged_chunk_attention`` through its reference
  at f32 atol 1e-5, the port's side in a child process without JAX;
- the kernel's algebra at several query tiles: a plain PyTorch mirror of
  the tiled split partials and their merge (each tile over its own live
  pages, each query over its own keys) against the same reference;
- the host-side plan: for every query tile at Tq > 64 and every
  ``cur_len``, the splits cover each of the tile's live pages once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.ops import paged_attention as jax_paged
from cloud_tpu_torch.ops import paged_attention as port_paged
from helpers.torch_port import run_port_side

torch.set_num_threads(1)

ATOL = 1e-5
H100_SMS = 132
H, HD, BT, NB = 2, 16, 16, 12

#: (Tq, S): the chunk widths of the serving path on rows long enough to
#: hold a chunk after a 3-block hit.
SHAPES = ((32, 96), (128, 192), (512, 576))
#: Per row: the chunk's start (``cur_len - 1``) and its pool-backed
#: leading pages.
ROWS = ((0, 0), (48, 3), (16, 1))


def _case(tq, s, *, pool, int8, seed):
    rng = np.random.default_rng(seed)
    b = len(ROWS)
    leaves = {n: rng.standard_normal((b, s, H, HD)).astype(np.float32)
              for n in ("k", "v")}
    pool_l, table = None, None
    if pool:
        pool_l = {n: rng.standard_normal((NB, BT, H, HD)).astype(np.float32)
                  for n in ("k", "v")}
        table = np.full((b, -(-s // BT)), -1, np.int32)
        for row, (_, pages) in enumerate(ROWS):
            table[row, :pages] = (np.arange(pages) * 5 + row) % NB
    if int8:
        leaves = _quantized(leaves)
        pool_l = None if pool_l is None else _quantized(pool_l)
    q = rng.standard_normal((b, tq, H, HD)).astype(np.float32)
    cur_len = np.array([start + 1 for start, _ in ROWS], np.int32)
    return q, leaves, cur_len, pool_l, table


def _quantized(tree):
    out = {}
    for name in ("k", "v"):
        q, scale = jax_gen._quantize_kv(jnp.asarray(tree[name]))
        out[name], out[f"{name}_scale"] = np.array(q), np.array(scale)
    return out


CASES = {f"tq{tq}-{'pool' if pool else 'slot'}-{'int8' if int8 else 'f32'}":
         (tq, s, pool, int8)
         for tq, s in SHAPES for pool in (False, True)
         for int8 in (False, True)}

_PORT_SIDE = """
import math
from cloud_tpu_torch.ops import paged_attention as pa


def leaves(prefix):
    out = {k[len(prefix):]: torch.from_numpy(v) for k, v in IN.items()
           if k.startswith(prefix)}
    return out or None


def tiled_split_combine(q, cache_l, cur_len, pool_l, table, n_split):
    # The kernel's algebra, query tile by query tile: each tile's partials
    # over its even share of the tile's own live pages, then the merge.
    def gather(name):
        return pa._gather_paged(cache_l[name], None if pool_l is None
                                else pool_l[name], table).float()

    b, tq, h, d = q.shape
    k, v = gather("k"), gather("v")
    s = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(d)
    v_scale = torch.ones((b, h, 1, s))
    if "k_scale" in cache_l:
        scores = scores * gather("k_scale").permute(0, 2, 3, 1)
        v_scale = gather("v_scale").permute(0, 2, 3, 1)
    j = torch.arange(s)
    valid = j[None, None, :] < (cur_len[:, None, None].long()
                                + torch.arange(tq)[None, :, None])
    scores = torch.where(valid[:, None], scores, pa.NEG_INF)
    out = torch.zeros((b, h, tq, d))
    for t0, t1 in pa.query_tiles(tq):
        x_tile = scores[:, :, t0:t1]
        parts = []
        for split in range(n_split):
            begin, end = [], []
            for row in range(b):
                n_live = pa.live_pages(int(cur_len[row]), t1, s, pa_bt)
                first, last = pa.split_pages(n_live, n_split, split)
                begin.append(first * pa_bt)
                end.append(min(last * pa_bt, s))
            begin, end = torch.tensor(begin), torch.tensor(end)
            inside = ((j[None] >= begin[:, None]) & (j[None] < end[:, None])
                      )[:, None, None, :]
            x = torch.where(inside, x_tile, -math.inf)
            empty = ~inside.any(-1, keepdim=True)
            m = torch.where(empty, pa.NEG_INF, x.amax(-1, keepdim=True))
            p = torch.exp(x - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("bhqk,bkhd->bhqd", p * v_scale, v)))
        m = torch.stack([part[0] for part in parts]).amax(0)
        w = [torch.exp(part[0] - m) for part in parts]
        l_sum = sum(wi * part[1] for wi, part in zip(w, parts))
        acc = sum(wi * part[2] for wi, part in zip(w, parts))
        out[:, :, t0:t1] = acc / torch.where(l_sum == 0, 1.0, l_sum)
    return out.permute(0, 2, 1, 3)


pa_bt = int(IN["bt"])
for name in [str(n) for n in IN["names"]]:
    q = torch.from_numpy(IN[name + ".q"])
    cache_l = leaves(name + ".slot.")
    pool_l = leaves(name + ".pool.")
    cur_len = torch.from_numpy(IN[name + ".cur_len"])
    table = (torch.from_numpy(IN[name + ".table"])
             if name + ".table" in IN else None)
    OUT[name + ".plain"] = pa.paged_chunk_attention(
        q, cache_l, cur_len, pool_l=pool_l, block_table=table).numpy()
    OUT[name + ".tiled"] = tiled_split_combine(
        q, cache_l, cur_len, pool_l, table, int(IN["n_split"])).numpy()
"""


@pytest.fixture(scope="module")
def chunk_runs(tmp_path_factory):
    """Per case: the JAX reference, the port's plain path and its tiled
    mirror of the kernel's algebra."""
    inputs = {"names": np.array(sorted(CASES)), "bt": np.array(BT),
              "n_split": np.array(3)}
    wants = {}
    for i, name in enumerate(sorted(CASES)):
        tq, s, pool, int8 = CASES[name]
        q, leaves, cur_len, pool_l, table = _case(tq, s, pool=pool,
                                                  int8=int8, seed=i)
        wants[name] = np.asarray(jax_paged.paged_chunk_attention(
            jnp.asarray(q), {k: jnp.asarray(v) for k, v in leaves.items()},
            jnp.asarray(cur_len),
            pool_l=None if pool_l is None else {
                k: jnp.asarray(v) for k, v in pool_l.items()},
            block_table=None if table is None else jnp.asarray(table),
            use_pallas=False))
        inputs[name + ".q"] = q
        inputs[name + ".cur_len"] = cur_len
        inputs.update({f"{name}.slot.{k}": v for k, v in leaves.items()})
        if pool_l is not None:
            inputs.update({f"{name}.pool.{k}": v for k, v in pool_l.items()})
            inputs[name + ".table"] = table
    got = run_port_side(_PORT_SIDE, inputs,
                        tmp_path_factory.mktemp("paged_chunks"))
    return wants, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_chunk_path_matches_jax_reference(chunk_runs, case):
    wants, got = chunk_runs
    np.testing.assert_allclose(got[case + ".plain"], wants[case], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if not c.startswith("tq32")))
def test_tiled_kernel_algebra_matches_jax_reference(chunk_runs, case):
    """Several query tiles (Tq 128, 512), three splits a tile: every query
    sees exactly its chunk-causal keys."""
    wants, got = chunk_runs
    np.testing.assert_allclose(got[case + ".tiled"], wants[case], atol=ATOL,
                               rtol=0)


PLAN_SHAPES = [(1, 12, s, 16, tq) for tq, s in ((65, 192), (128, 576),
                                                 (512, 576))] + [
    (8, 12, 576, 16, 128), (1, 2, 4096, 128, 512)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_splits_cover_every_query_tile_page_once(shape):
    b, h, s, bt, tq = shape
    n_split = port_paged.plan_splits(b, h, s, bt, H100_SMS, tq)
    tiles = port_paged.query_tiles(tq)
    assert [t1 - t0 for t0, t1 in tiles][:-1] == [
        port_paged.KERNEL_QUERY_TILE] * (len(tiles) - 1)
    assert tiles[0][0] == 0 and tiles[-1][1] == tq
    assert 1 <= n_split <= min(-(-s // bt), port_paged.MAX_SPLITS)
    assert len(tiles) * n_split <= 65535  # the grid's z dimension
    for cur_len in range(1, s + 1):
        for t0, t1 in tiles:
            n_live = port_paged.live_pages(cur_len, t1, s, bt)
            # The tile's last query sees keys below cur_len + t1 - 1.
            assert n_live * bt >= min(cur_len + t1 - 1, s)
            covered = []
            for split in range(n_split):
                first, end = port_paged.split_pages(n_live, n_split, split)
                covered.extend(range(first, end))
            assert covered == list(range(n_live)), (cur_len, t0)


def test_plan_counts_query_tiles():
    """More query tiles, fewer splits a tile: the blocks stay near
    ``SPLIT_BLOCKS_PER_SM`` a SM; one tile plans as before."""
    one = port_paged.plan_splits(1, 12, 576, 16, H100_SMS, 1)
    assert one == port_paged.plan_splits(1, 12, 576, 16, H100_SMS)
    assert one == port_paged.plan_splits(1, 12, 576, 16, H100_SMS, 64)
    eight = port_paged.plan_splits(1, 12, 576, 16, H100_SMS, 512)
    assert eight == -(-port_paged.SPLIT_BLOCKS_PER_SM * H100_SMS // (12 * 8))
    assert eight < one
