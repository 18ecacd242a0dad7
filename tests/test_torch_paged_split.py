"""The split-page (flash-decoding) plan of K8/K8q, on the CPU.

The CUDA kernel divides a row's live pages across ``plan_splits`` blocks,
each writing a partial ``(m, l, acc)``, and a second kernel merges them.
No card runs here, so two things are pinned on the CPU:

- the host-side plan: for every shape ``chip_smoke.py`` runs the kernel at,
  slot rows of 576 and 4096 positions, and every ``cur_len`` from 1 to S,
  the splits (``split_pages``, the kernel's own arithmetic) cover every live
  page exactly once;
- the algebra: a plain PyTorch mirror of the split partials and their
  combine, held against the JAX package's paged reference on the same
  numpy-seeded inputs (f32, atol 1e-5) with empty and all-masked splits,
  ``cur_len`` of 1 and of S, Tq = 4, pool pages and int8 K/V with scales;
  and, where a query has no valid key at all, against one split (the
  single pass).
"""

import importlib.util
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.ops import paged_attention as jax_paged
from cloud_tpu_torch.ops import paged_attention as port_paged

torch.set_num_threads(2)

ATOL = 1e-5
H100_SMS = 132


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
#: (B, H, S, bt) of every paged call ``chip_smoke.py`` makes: its slot rows
#: with no pool (the page ``_fit_page`` picks) and with a 16-token pool.
CHIP_SHAPES = sorted({
    (CS.NUM_SLOTS, CS.HEADS, s, bt)
    for s in CS.PAGED_LENGTHS
    for bt in (port_paged._fit_page(s, None), 16)})


def _live_pages(cur_len, tq, s, bt):
    limit = cur_len + tq - 1
    return 0 if limit <= 0 else min(-(-limit // bt), -(-s // bt))


@pytest.mark.parametrize("shape", CHIP_SHAPES, ids=str)
def test_splits_cover_every_live_page_once(shape):
    b, h, s, bt = shape
    n_split = port_paged.plan_splits(b, h, s, bt, H100_SMS)
    n_pages = -(-s // bt)
    assert 1 <= n_split <= min(n_pages, port_paged.MAX_SPLITS)
    if n_split < min(n_pages, port_paged.MAX_SPLITS):
        assert b * h * n_split >= 2 * H100_SMS
    for tq in (1, 4):
        for cur_len in range(1, s + 1):
            n_live = _live_pages(cur_len, tq, s, bt)
            covered = []
            for split in range(n_split):
                first, end = port_paged.split_pages(n_live, n_split, split)
                assert 0 <= first <= end <= n_live
                assert end - first <= -(-n_live // n_split)  # even shares
                covered.extend(range(first, end))
            assert covered == list(range(n_live)), (cur_len, tq)


def test_plan_uses_static_shapes_only():
    """More rows or heads, fewer splits; never narrower than a page."""
    assert port_paged.plan_splits(8, 12, 576, 128, H100_SMS) == 5
    assert port_paged.plan_splits(8, 12, 4096, 128, H100_SMS) == 6
    assert port_paged.plan_splits(1, 12, 4096, 128, H100_SMS) == 32
    assert port_paged.plan_splits(64, 12, 4096, 128, H100_SMS) == 1
    assert port_paged.plan_splits(1, 1, 100, 128, H100_SMS) == 1


def split_combine(q, cache_l, cur_len, pool_l, block_table, *, bt, n_split):
    """The kernel's algebra in plain f32 PyTorch: each split's partial over
    its even share of the live pages (keys of other splits are no keys;
    keys at or past ``cur_len + t`` score NEG_INF; int8 leaves fold
    ``k_scale`` into the scores and ``v_scale`` into the weights after the
    sum ``l``), an empty split ``(NEG_INF, 0, 0)``, then the merge
    ``sum exp(m_i - m) acc_i / sum exp(m_i - m) l_i``, zeros where that
    sum is 0."""
    def gather(name):
        return port_paged._gather_paged(
            cache_l[name], None if pool_l is None else pool_l[name],
            block_table).float()

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
    scores = torch.where(valid[:, None], scores, port_paged.NEG_INF)
    parts = []
    for split in range(n_split):
        begin, end = [], []
        for row in range(b):
            first, last = port_paged.split_pages(
                _live_pages(int(cur_len[row]), tq, s, bt), n_split, split)
            begin.append(first * bt)
            end.append(min(last * bt, s))
        begin, end = torch.tensor(begin), torch.tensor(end)
        inside = ((j[None] >= begin[:, None]) & (j[None] < end[:, None])
                  )[:, None, None, :]                  # [B, 1, 1, S]
        x = torch.where(inside, scores, -math.inf)
        empty = ~inside.any(-1, keepdim=True)          # [B, 1, 1, 1]
        m = torch.where(empty, port_paged.NEG_INF,
                        x.amax(-1, keepdim=True))      # [B, H, Tq, 1]
        p = torch.exp(x - m)
        l_i = p.sum(-1, keepdim=True)
        acc = torch.einsum("bhqk,bkhd->bhqd", p * v_scale, v)
        parts.append((m, l_i, acc))
    m = torch.stack([part[0] for part in parts]).amax(0)
    weights = [torch.exp(part[0] - m) for part in parts]
    l_sum = sum(w * part[1] for w, part in zip(weights, parts))
    acc = sum(w * part[2] for w, part in zip(weights, parts))
    out = acc / torch.where(l_sum == 0, 1.0, l_sum)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _case(rng, *, b, s, h=2, hd=16, nb=6, bt=8, pool):
    leaves = {n: rng.standard_normal((b, s, h, hd)).astype(np.float32)
              for n in ("k", "v")}
    if not pool:
        return leaves, None, None
    pool_l = {n: rng.standard_normal((nb, bt, h, hd)).astype(np.float32)
              for n in ("k", "v")}
    table = np.full((b, -(-s // bt)), -1, np.int32)
    for row in range(b):  # pool-backed leading pages, slot pages after
        table[row, :row % 3 + 1] = (np.arange(row % 3 + 1) + 2 * row) % nb
    table[b - 1, 4] = 1  # a pool page between slot pages
    return leaves, pool_l, table


def _quantized(tree):
    out = {}
    for name in ("k", "v"):
        q, scale = jax_gen._quantize_kv(jnp.asarray(tree[name]))
        out[name], out[f"{name}_scale"] = np.array(q), np.array(scale)
    return out


def _torch(tree):
    return None if tree is None else {
        k: torch.from_numpy(v) for k, v in tree.items()}


#: (cur_len, tq, n_split, pool, int8): rows with fewer live pages than
#: splits (empty splits), splits whose keys are all masked for the first
#: queries (Tq = 4 on long rows), cur_len of 1 and of S, pool pages, int8.
ALGEBRA_CASES = {
    "short-rows-empty-splits": ([1, 3, 9, 17], 1, 8, False, False),
    "all-masked-splits-tq4": ([8, 24, 40, 63], 4, 8, False, False),
    "len-1-and-S-tq4": ([1, 64, 2, 62], 4, 3, False, False),
    "len-1-and-S-tq1": ([1, 64, 33, 64], 1, 5, False, False),
    "pool-pages": ([5, 20, 41, 64], 4, 6, True, False),
    "int8": ([1, 64, 23, 50], 4, 8, False, True),
    "int8-pool": ([2, 64, 30, 47], 1, 4, True, True),
}


@pytest.mark.parametrize("case", sorted(ALGEBRA_CASES))
def test_split_combine_matches_jax_reference(case):
    lens, tq, n_split, pool, int8 = ALGEBRA_CASES[case]
    rng = np.random.default_rng(sorted(ALGEBRA_CASES).index(case))
    b, s, bt = len(lens), 64, 8
    leaves, pool_l, table = _case(rng, b=b, s=s, bt=bt, pool=pool)
    if int8:
        leaves = _quantized(leaves)
        pool_l = None if pool_l is None else _quantized(pool_l)
    q = rng.standard_normal((b, tq, 2, 16)).astype(np.float32)
    cur_len = np.array(lens, np.int32)
    got = split_combine(torch.from_numpy(q), _torch(leaves),
                        torch.from_numpy(cur_len), _torch(pool_l),
                        None if table is None else torch.from_numpy(table),
                        bt=bt, n_split=n_split)
    want = jax_paged._reference(
        jnp.asarray(q), {k: jnp.asarray(v) for k, v in leaves.items()},
        jnp.asarray(cur_len),
        None if pool_l is None else {k: jnp.asarray(v)
                                     for k, v in pool_l.items()},
        None if table is None else jnp.asarray(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_combine_reproduces_one_pass_without_valid_keys():
    """``cur_len = 0`` with Tq = 4: query 0 sees no valid key, so its
    softmax is uniform over the live keys it visits.  Split in 1 to 4
    pieces, the merge gives the single pass's answer (split 1) for every
    query, the empty and the all-masked splits included."""
    rng = np.random.default_rng(7)
    leaves, _, _ = _case(rng, b=3, s=32, pool=False)
    q = torch.from_numpy(rng.standard_normal((3, 4, 2, 16)).astype(
        np.float32))
    cur_len = torch.tensor([0, 9, 30], dtype=torch.int32)
    one = split_combine(q, _torch(leaves), cur_len, None, None, bt=8,
                        n_split=1)
    assert torch.isfinite(one).all()
    for n_split in (2, 3, 4):
        got = split_combine(q, _torch(leaves), cur_len, None, None, bt=8,
                            n_split=n_split)
        np.testing.assert_allclose(got.numpy(), one.numpy(), atol=ATOL,
                                   rtol=0)
