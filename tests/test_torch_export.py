"""The port's pretrained bundles on the CPU, against the JAX package's.

``config.json`` equals the JAX package's for the same config (CloudLM
with a nested ``MoeConfig``, BERT, ViT, ResNet; an int8 tree's
``"quantized"`` stamp), apart from ``"module"``; a ``config.json`` the JAX
package wrote loads into the port's config class; params round-trip bit
for bit (quantized bundles, bf16 leaves and an MoE tree included) and a
loaded bundle generates the same tokens; and the staged swap behaves as
the JAX package's does: the layout, re-export, the legacy layout and its
migration, an interrupted swap and a crash while staging.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import pytest
import torch

from cloud_tpu.models import bert as jax_bert
from cloud_tpu.models import export as jax_export
from cloud_tpu.models import moe as jax_moe
from cloud_tpu.models import quantization as jax_quant
from cloud_tpu.models import resnet as jax_resnet
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu.models import vit as jax_vit
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import (bert, export, generation, moe,
                                    quantization, resnet, transformer, vit)

torch.set_num_threads(1)

MOE_KW = dict(num_experts=4, top_k=2, z_loss_weight=1e-3)


def _port_config(jax_cfg, port_cls):
    """The port's config with the JAX config's fields, dtypes mapped."""
    fields = {}
    for f in dataclasses.fields(jax_cfg):
        value = getattr(jax_cfg, f.name)
        if f.name == "dtype":
            value = getattr(torch, jnp.dtype(value).name)
        elif f.name == "moe" and value is not None:
            value = moe.MoeConfig(**dataclasses.asdict(value))
        fields[f.name] = value
    return port_cls(**fields)


#: family -> (JAX config, port config class); each config off its
#: defaults somewhere.
FAMILIES = {
    "transformer-moe": (jax_tf.TINY.scaled(
        tied_embeddings=True, moe=jax_moe.MoeConfig(**MOE_KW)),
        transformer.TransformerConfig),
    "transformer-f32": (jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2,
                                           remat_policy="dots"),
                        transformer.TransformerConfig),
    "bert": (dataclasses.replace(jax_bert.TINY, remat="dots"),
             bert.BertConfig),
    "vit": (jax_vit.VIT_TINY_CIFAR.scaled(num_layers=2, pooling="cls"),
            vit.ViTConfig),
    "resnet": (jax_resnet.RESNET8_CIFAR, resnet.ResNetConfig),
}


def _without_module(obj):
    return {k: v for k, v in obj.items() if k != "module"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_json_equals_jax(family):
    jax_cfg, cls = FAMILIES[family]
    cfg = _port_config(jax_cfg, cls)
    got = json.loads(json.dumps(export.config_to_json(cfg)))
    want = json.loads(json.dumps(jax_export._config_to_json(jax_cfg)))
    assert _without_module(got) == _without_module(want)
    assert got["module"] == want["module"].replace("cloud_tpu.",
                                                   "cloud_tpu_torch.")
    assert export.config_from_json(got) == cfg


@pytest.mark.parametrize("family", ["transformer-moe", "vit"])
def test_jax_written_config_loads_into_the_port(family, tmp_path):
    """A bundle the JAX package saved: its ``config.json`` reads into the
    port's config class, nested ``MoeConfig`` and dtype included."""
    jax_cfg, cls = FAMILIES[family]
    init = jax_tf.init if cls is transformer.TransformerConfig else \
        jax_vit.init
    params = init(jax.random.PRNGKey(0), jax_cfg)
    jax_export.save_pretrained(str(tmp_path / "m"), params, jax_cfg)
    with open(tmp_path / "m" / "bundle" / "config.json") as f:
        obj = json.load(f)
    assert obj["module"].startswith("cloud_tpu.models.")
    assert export.config_from_json(obj) == _port_config(jax_cfg, cls)


def test_quantized_stamp_equals_jax(tmp_path):
    jax_cfg = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2,
                                 moe=jax_moe.MoeConfig(**MOE_KW))
    jparams = jax_tf.init(jax.random.PRNGKey(0), jax_cfg)
    jax_export.save_pretrained(str(tmp_path / "jax"),
                               jax_quant.quantize_params(jparams), jax_cfg)
    cfg = _port_config(jax_cfg, transformer.TransformerConfig)
    params = quantization.quantize_params(
        bridge.to_torch(jparams, cfg, device="cpu"))
    export.save_pretrained(str(tmp_path / "port"), params, cfg)
    with open(tmp_path / "jax" / "config.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / "config.json") as f:
        got = json.load(f)
    assert got["quantized"] is True
    assert _without_module(got) == _without_module(want)


def _lm(seed=0, **kw):
    cfg = transformer.TINY.scaled(dtype=torch.float32, num_layers=2, **kw)
    return cfg, bridge.init(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")


def _assert_trees_equal(a, b):
    assert bridge.map_leaves(a, lambda t: None) == \
        bridge.map_leaves(b, lambda t: None)
    for x, y in zip(bridge.leaves(a), bridge.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


ROUND_TRIPS = {
    "transformer-moe": lambda: _lm(moe=moe.MoeConfig(**MOE_KW),
                                   tied_embeddings=True),
    "transformer-int8-moe": lambda: (
        lambda c, p: (c, quantization.quantize_params(p)))(
            *_lm(moe=moe.MoeConfig(**MOE_KW))),
    "transformer-bf16": lambda: (
        lambda c, p: (c.scaled(dtype=torch.bfloat16),
                      bridge.map_leaves(p, lambda t: t.bfloat16())))(*_lm()),
    "bert": lambda: (bert.TINY, bridge.init_bert(
        bert.TINY, torch.Generator().manual_seed(0), device="cpu")),
    "vit": lambda: (vit.VIT_TINY_CIFAR.scaled(pooling="cls"), bridge.init_vit(
        vit.VIT_TINY_CIFAR.scaled(pooling="cls"),
        torch.Generator().manual_seed(0), device="cpu")),
    "resnet": lambda: (resnet.RESNET8_CIFAR, bridge.init_resnet(
        resnet.RESNET8_CIFAR, torch.Generator().manual_seed(0),
        device="cpu")),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_params_round_trip_bit_for_bit(case, tmp_path):
    cfg, params = ROUND_TRIPS[case]()
    export.save_pretrained(str(tmp_path / "m"), params, cfg)
    loaded, cfg2 = export.load_pretrained(str(tmp_path / "m"), device="cpu")
    assert cfg2 == cfg
    _assert_trees_equal(loaded, params)
    with open(tmp_path / "m" / "config.json") as f:
        assert json.load(f).get("quantized", False) == ("int8" in case)


def test_load_into_a_template(tmp_path):
    cfg, params = _lm()
    export.save_pretrained(str(tmp_path / "m"), params, cfg)
    template = bridge.map_leaves(params, torch.zeros_like)
    loaded, _ = export.load_pretrained(str(tmp_path / "m"),
                                       template=template, device="cpu")
    _assert_trees_equal(loaded, params)
    bad = dict(template, ln_f={"scale": torch.zeros(3)})
    with pytest.raises(ValueError, match="template"):
        export.load_pretrained(str(tmp_path / "m"), template=bad,
                               device="cpu")


def test_loaded_moe_bundle_generates_the_same_tokens(tmp_path):
    cfg, params = _lm(moe=moe.MoeConfig(**MOE_KW))
    export.save_pretrained(str(tmp_path / "lm"), params, cfg)
    params2, cfg2 = export.load_pretrained(str(tmp_path / "lm"),
                                           device="cpu")
    prompt = torch.tensor([[5, 9, 17, 2]], dtype=torch.int32)
    lens = torch.tensor([4])
    got = generation.generate(params2, prompt, lens, cfg2, max_new_tokens=4,
                              device="cpu")["tokens"]
    want = generation.generate(params, prompt, lens, cfg, max_new_tokens=4,
                               device="cpu")["tokens"]
    assert torch.equal(got, want)


def test_re_export_replaces_params(tmp_path):
    cfg, p1 = _lm(0)
    _, p2 = _lm(1)
    d = str(tmp_path / "m")
    export.save_pretrained(d, p1, cfg)
    export.save_pretrained(d, p2, cfg)
    loaded, _ = export.load_pretrained(d, device="cpu")
    _assert_trees_equal(loaded, p2)


def test_unknown_family_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown model family"):
        export.save_pretrained(str(tmp_path / "x"), {}, object())
    with pytest.raises(ValueError, match="unknown"):
        export.config_from_json({"module": "cloud_tpu.models.mnist",
                                 "config": {}})


def test_bundle_layout_and_convenience_copy(tmp_path):
    cfg, params = _lm()
    d = tmp_path / "m"
    export.save_pretrained(str(d), params, cfg)
    assert (d / "bundle" / "config.json").is_file()
    assert (d / "bundle" / "params").is_dir()
    with open(d / "bundle" / "config.json") as f:
        inner = json.load(f)
    with open(d / "config.json") as f:
        assert json.load(f) == inner
    assert not os.path.exists(d / "bundle.saving")
    assert not os.path.exists(d / "bundle.old")


def _to_legacy(d):
    shutil.move(str(d / "bundle" / "params"), str(d / "params"))
    shutil.rmtree(d / "bundle")


def test_legacy_layout_loads_and_migrates(tmp_path):
    cfg, p_old = _lm(0)
    _, p_new = _lm(1)
    d = tmp_path / "m"
    export.save_pretrained(str(d), p_old, cfg)
    _to_legacy(d)
    (d / "bundle.saving").mkdir()  # a crash while staging blocks nothing
    loaded, cfg2 = export.load_pretrained(str(d), device="cpu")
    assert cfg2 == cfg
    _assert_trees_equal(loaded, p_old)
    export.save_pretrained(str(d), p_new, cfg)
    assert not os.path.exists(d / "params")
    loaded, _ = export.load_pretrained(str(d), device="cpu")
    _assert_trees_equal(loaded, p_new)


def test_interrupted_swap_fails_loudly_then_resave_recovers(tmp_path):
    cfg, p1 = _lm(0)
    _, p2 = _lm(1)
    d = tmp_path / "m"
    export.save_pretrained(str(d), p1, cfg)
    os.rename(d / "bundle", d / "bundle.old")  # killed between the renames
    with pytest.raises(RuntimeError, match="interrupted save"):
        export.load_pretrained(str(d), device="cpu")
    export.save_pretrained(str(d), p2, cfg)
    assert not os.path.exists(d / "bundle.old")
    loaded, _ = export.load_pretrained(str(d), device="cpu")
    _assert_trees_equal(loaded, p2)
