"""The port's attention ops against the JAX package's, on the CPU.

On CPU tensors the port's wrappers take their plain PyTorch versions;
these are held against the JAX package's functions on the same numpy
inputs, in f32 at atol 1e-5: the flash forward against
``flash_attention(..., use_pallas=False)`` and ``_reference_with_lse``,
the paged attention against the Pallas kernel in interpret mode and
against its jnp reference, with full-precision and with int8 (``kv_quant``)
K/V, whose post-scale algebra must also equal attention over the
explicitly dequantized K/V.  The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu_torch.models import quantization
from cloud_tpu_torch.ops import flash_attention as port_flash
from cloud_tpu_torch.ops import paged_attention as port_paged

jax_flash = importlib.import_module("cloud_tpu.ops.flash_attention")
jax_paged = importlib.import_module("cloud_tpu.ops.paged_attention")
jax_gen = importlib.import_module("cloud_tpu.models.generation")

torch.set_num_threads(2)

ATOL = 1e-5


def _qkv(rng, b, t, h, d):
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _mask(rng, kind, b, t):
    if kind is None:
        return None
    if kind == "prefix":  # the prefill shape: right-padded prompts
        lens = rng.integers(1, t + 1, b)
        return (np.arange(t)[None, :] < lens[:, None]).astype(np.int32)
    mask = (rng.random((b, t)) > 0.4).astype(np.int32)
    mask[0, :] = 0  # one batch row with no valid key at all
    return mask


@pytest.mark.parametrize("t", [16, 37, 64])
@pytest.mark.parametrize("mask_kind", [None, "prefix", "random"])
def test_flash_plain_matches_jax(t, mask_kind):
    rng = np.random.default_rng(t)
    q, k, v = _qkv(rng, 2, t, 3, 16)
    mask = _mask(rng, mask_kind, 2, t)
    out, lse = port_flash.flash_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), causal=True,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    jmask = None if mask is None else jnp.asarray(mask)
    ref_out, ref_lse = jax_flash._reference_with_lse(
        q, k, v, causal=True, mask=jmask)
    api_out, api_lse = jax_flash.flash_attention_with_lse(
        q, k, v, causal=True, mask=jmask, use_pallas=False)
    for want_out, want_lse in ((ref_out, ref_lse), (api_out, api_lse)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                                   atol=ATOL, rtol=1e-6)
    assert torch.equal(
        port_flash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   mask=None if mask is None
                                   else torch.from_numpy(mask)),
        out,
    )


def test_flash_plain_non_causal():
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 24, 2, 16)
    out = port_flash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=False)
    want = jax_flash.flash_attention(q, k, v, causal=False, use_pallas=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("view", ["offset", "strided"])
def test_flash_kernel_rows_are_aligned(view):
    """The bf16 kernels copy rows in 16-byte pieces: ``_check_qkv`` (and
    ``_bwd_launch``'s dO) pass an aligned tensor through untouched and
    copy a view whose rows start off a 16-byte boundary or are not
    contiguous.  A CPU tensor still takes the plain version and counts no
    launch."""
    from cloud_tpu_torch.ops import dispatch

    b, t, h, d = 2, 8, 3, 16
    n = b * t * h * d
    if view == "offset":  # one bf16 element (2 bytes) past an aligned base
        x = torch.randn(n + 1).to(torch.bfloat16)[1:].view(b, t, h, d)
    else:  # every other head dim
        x = torch.randn(b, t, h, 2 * d).to(torch.bfloat16)[..., ::2]
    assert not (x.is_contiguous() and x.data_ptr() % 16 == 0)
    aligned = torch.randn(b, t, h, d).to(torch.bfloat16)
    got = port_flash._check_qkv(x, aligned, aligned)
    assert got[0].is_contiguous() and got[0].data_ptr() % 16 == 0
    assert torch.equal(got[0], x)
    assert got[1] is aligned and got[2] is aligned
    dispatch.reset_launch_counts()
    out = port_flash.flash_attention(x, x, x)
    want, _ = port_flash._reference_with_lse(x, x, x, causal=True, mask=None)
    assert torch.equal(out, want)
    assert all(n == 0 for n in dispatch.launch_counts().values())


def test_flash_f32_rows_need_unit_stride_only():
    """The f32 kernels read element by element: ``_check_qkv`` passes an
    f32 view whose rows start off a 16-byte boundary untouched and copies
    only a view whose last stride is not 1."""
    b, t, h, d = 2, 8, 3, 16
    offset = torch.randn(b * t * h * d + 1)[1:].view(b, t, h, d)
    assert offset.data_ptr() % 16 != 0
    strided = torch.randn(b, t, h, 2 * d)[..., ::2]
    got = port_flash._check_qkv(offset, offset, strided)
    assert got[0] is offset and got[1] is offset
    assert got[2].stride(-1) == 1 and torch.equal(got[2], strided)


def _paged_case(rng, *, b=3, s=40, h=2, hd=16, nb=5, bt=8):
    leaves = {n: rng.standard_normal((b, s, h, hd)).astype(np.float32)
              for n in ("k", "v")}
    pool = {n: rng.standard_normal((nb, bt, h, hd)).astype(np.float32)
            for n in ("k", "v")}
    n_pages = -(-s // bt)
    table = np.full((b, n_pages), -1, np.int32)
    table[0, :3] = [4, 0, 2]      # pool-backed head, slot tail
    table[1, 1] = 3               # a pool page between slot pages
    table[2, :] = -1              # slot only
    return leaves, pool, table


def _to_torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("tq", [1, 4])
@pytest.mark.parametrize("with_pool", [False, True])
def test_paged_plain_matches_jax(tq, with_pool):
    rng = np.random.default_rng(10 * tq + with_pool)
    leaves, pool, table = _paged_case(rng)
    s = leaves["k"].shape[1]
    q = rng.standard_normal((3, tq, 2, 16)).astype(np.float32)
    cur_len = np.array([1, 19, s - tq + 1], np.int32)
    port_fn = (port_paged.paged_decode_attention if tq == 1
               else port_paged.paged_chunk_attention)
    jax_fn = (jax_paged.paged_decode_attention if tq == 1
              else jax_paged.paged_chunk_attention)
    got = port_fn(
        torch.from_numpy(q), _to_torch(leaves), torch.from_numpy(cur_len),
        pool_l=_to_torch(pool) if with_pool else None,
        block_table=torch.from_numpy(table) if with_pool else None,
    )
    for use_pallas in (True, False):
        want = jax_fn(
            jnp.asarray(q), {k: jnp.asarray(v) for k, v in leaves.items()},
            jnp.asarray(cur_len),
            pool_l=({k: jnp.asarray(v) for k, v in pool.items()}
                    if with_pool else None),
            block_table=jnp.asarray(table) if with_pool else None,
            use_pallas=use_pallas,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_paged_verify_and_narrow_table_match_jax():
    """The verify entry point, and a block table narrower than the row
    (positions past its coverage read the slot row)."""
    rng = np.random.default_rng(3)
    leaves, pool, table = _paged_case(rng)
    q = rng.standard_normal((3, 3, 2, 16)).astype(np.float32)
    cur_len = np.array([5, 17, 30], np.int32)
    narrow = table[:, :2]
    got = port_paged.paged_verify_attention(
        torch.from_numpy(q), _to_torch(leaves), torch.from_numpy(cur_len),
        pool_l=_to_torch(pool), block_table=torch.from_numpy(narrow),
    )
    want = jax_paged.paged_verify_attention(
        q, leaves, cur_len, pool_l=pool, block_table=narrow,
        use_pallas=False,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_paged_gather_matches_jax():
    rng = np.random.default_rng(4)
    leaves, pool, table = _paged_case(rng)
    got = port_paged._gather_paged(torch.from_numpy(leaves["k"]),
                                   torch.from_numpy(pool["k"]),
                                   torch.from_numpy(table))
    want = jax_paged._gather_paged(leaves["k"], pool["k"], table)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s,want", [(40, 40), (200, 128), (5, None)])
def test_fit_page_matches_jax(s, want):
    assert port_paged._fit_page(s, None) == jax_paged._fit_page(s, None) == want
    assert port_paged._fit_page(s, 16) == 16


def _quantized(tree):
    """int8 K/V with per-(position, head) f32 scales, made by the JAX
    package's own quantizer (numpy leaves)."""
    out = {}
    for name in ("k", "v"):
        q, scale = jax_gen._quantize_kv(jnp.asarray(tree[name]))
        out[name], out[f"{name}_scale"] = np.array(q), np.array(scale)
    return out


@pytest.mark.parametrize("tq", [1, 4])
@pytest.mark.parametrize("with_pool", [False, True])
def test_paged_int8_plain_matches_jax(tq, with_pool):
    """K8q's plain version against the JAX quantized branch: the Pallas
    kernel in interpret mode and its jnp reference."""
    rng = np.random.default_rng(20 + 10 * tq + with_pool)
    leaves, pool, table = _paged_case(rng)
    leaves, pool = _quantized(leaves), _quantized(pool)
    assert leaves["k"].dtype == np.int8
    s = leaves["k"].shape[1]
    q = rng.standard_normal((3, tq, 2, 16)).astype(np.float32)
    cur_len = np.array([3, 21, s - tq + 1], np.int32)
    port_fn = (port_paged.paged_decode_attention if tq == 1
               else port_paged.paged_chunk_attention)
    jax_fn = (jax_paged.paged_decode_attention if tq == 1
              else jax_paged.paged_chunk_attention)
    got = port_fn(
        torch.from_numpy(q), _to_torch(leaves), torch.from_numpy(cur_len),
        pool_l=_to_torch(pool) if with_pool else None,
        block_table=torch.from_numpy(table) if with_pool else None,
    )
    for use_pallas in (True, False):
        want = jax_fn(
            jnp.asarray(q), {k: jnp.asarray(v) for k, v in leaves.items()},
            jnp.asarray(cur_len),
            pool_l=({k: jnp.asarray(v) for k, v in pool.items()}
                    if with_pool else None),
            block_table=jnp.asarray(table) if with_pool else None,
            use_pallas=use_pallas,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("with_pool", [False, True])
def test_paged_int8_post_scale_equals_dequantized(with_pool):
    """Folding k_scale into the scores and v_scale into the weights is
    attention over ``q * scale`` K/V, up to f32 rounding."""
    rng = np.random.default_rng(9)
    raw, raw_pool, table = _paged_case(rng)
    cur_len = torch.tensor([16, 11, 40], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((3, 1, 2, 16)).astype(
        np.float32))

    def quant(tree):
        out = {}
        for name in ("k", "v"):
            out[name], out[f"{name}_scale"] = quantization.quantize_unchecked(
                torch.from_numpy(tree[name]), axis=-1)
        return out

    def dequant(tree):
        return {n: tree[n].float() * tree[f"{n}_scale"] for n in ("k", "v")}

    cache, pool = quant(raw), quant(raw_pool)
    extra = dict(pool_l=pool, block_table=torch.from_numpy(table)
                 ) if with_pool else {}
    got = port_paged.paged_decode_attention(q, cache, cur_len, **extra)
    if with_pool:
        extra["pool_l"] = dequant(pool)
    want = port_paged.paged_decode_attention(q, dequant(cache), cur_len,
                                             **extra)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_wrappers_refuse_other_devices_and_int8():
    """Other devices raise; so does a slot row and a pool of different
    precision (int8 with scales against full precision, either way)."""
    q = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_flash.flash_attention(q, q, q)
    cache = {"k": torch.zeros((1, 8, 2, 16), device="meta"),
             "v": torch.zeros((1, 8, 2, 16), device="meta")}
    with pytest.raises(ValueError, match="unsupported device"):
        port_paged.paged_decode_attention(q[:, :1], cache,
                                          torch.ones(1, dtype=torch.int32))
    int8 = {"k": torch.zeros((1, 8, 2, 16), dtype=torch.int8),
            "k_scale": torch.ones((1, 8, 2, 1)),
            "v": torch.zeros((1, 8, 2, 16), dtype=torch.int8),
            "v_scale": torch.ones((1, 8, 2, 1))}
    full = {"k": torch.zeros((1, 8, 2, 16)), "v": torch.zeros((1, 8, 2, 16))}
    table = torch.full((1, 1), -1, dtype=torch.int32)
    for slot, pool in ((int8, full), (full, int8),
                       ({"k": int8["k"], "v": int8["v"]}, None)):
        with pytest.raises(TypeError, match="int8"):
            port_paged.paged_decode_attention(
                torch.zeros((1, 1, 2, 16)), slot,
                torch.ones(1, dtype=torch.int32), pool_l=pool,
                block_table=None if pool is None else table)


def test_launch_counts_lose_no_update_across_threads():
    """The engine's warmup worker and its scheduler count launches at
    once: 8 threads, 2000 counts each, a short switch interval."""
    import sys
    import threading

    from cloud_tpu_torch.ops import dispatch

    dispatch.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            dispatch.count_launch("paged_attention") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert dispatch.launch_counts(["paged_attention"]) == {
            "paged_attention": 8 * 2000}
    finally:
        dispatch.reset_launch_counts()
