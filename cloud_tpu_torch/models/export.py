"""Pretrained-model bundles: (config, params) save and load for the zoo (port of ``cloud_tpu/models/export.py``).

A bundle is a directory holding ``config.json`` (the model's dataclass
config and the module that owns it) and the params tree in the port's own
checkpoint format (:mod:`cloud_tpu_torch.training.checkpoint`: one raw
file a leaf, nothing pickled; the JAX package writes Orbax there).
:func:`load_pretrained` rebuilds both without the caller knowing which
model family the bundle holds: CloudLM (MoE included), BERT, ViT or
ResNet.

``config.json`` has the JAX package's keys and values for the same config
(dtypes by name, a nested ``MoeConfig`` as a dict, ``"quantized": true``
on a weight-only int8 tree); only ``"module"`` names the port's module.
The loader takes the JAX package's module names too, so the
``config.json`` of a JAX bundle reads into the port's config class.

The (config, params) pair is staged as one directory and swapped in
whole, as in the JAX package, so no kill point pairs new params with a
stale config.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import typing
from typing import Any, Optional, Tuple

import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.training.checkpoint import CheckpointManager

#: Model families by module name: each has the Config dataclass named here.
_CONFIG_CLASSES = {
    "cloud_tpu_torch.models.transformer": "TransformerConfig",
    "cloud_tpu_torch.models.bert": "BertConfig",
    "cloud_tpu_torch.models.vit": "ViTConfig",
    "cloud_tpu_torch.models.resnet": "ResNetConfig",
}
#: The JAX package's module names of the same families.
_JAX_MODULES = {
    "cloud_tpu.models." + name.rsplit(".", 1)[1]: name
    for name in _CONFIG_CLASSES
}

_DTYPE_KEY = "dtype"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def config_to_json(config: Any) -> dict:
    """``{"module", "config"}``: the JSON form of a zoo config."""
    module = type(config).__module__
    if module not in _CONFIG_CLASSES:
        raise ValueError(
            f"unknown model family {module!r}; exportable families: "
            f"{sorted(_CONFIG_CLASSES)}"
        )
    fields = dataclasses.asdict(config)  # a nested MoeConfig becomes a dict
    if _DTYPE_KEY in fields:
        fields[_DTYPE_KEY] = _dtype_name(fields[_DTYPE_KEY])
    return {"module": module, "config": fields}


def config_from_json(obj: dict) -> Any:
    """The config of :func:`config_to_json`'s form, the port's class;
    a JAX package's module name maps to the port's module."""
    module_name = _JAX_MODULES.get(obj["module"], obj["module"])
    class_name = _CONFIG_CLASSES.get(module_name)
    if class_name is None:
        raise ValueError(f"bundle's model family {obj['module']!r} unknown")
    module = importlib.import_module(module_name)
    cls = getattr(module, class_name)
    fields = dict(obj["config"])
    if _DTYPE_KEY in fields:
        dtype = getattr(torch, fields[_DTYPE_KEY], None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown dtype {fields[_DTYPE_KEY]!r}")
        fields[_DTYPE_KEY] = dtype
    # A nested config (TransformerConfig.moe) rebuilds from its dict; JSON
    # arrays come back as lists, and the zoo's frozen configs use tuples.
    for f in dataclasses.fields(cls):
        value = fields.get(f.name)
        if isinstance(value, dict):
            fields[f.name] = _nested_type(cls, f.name)(**value)
        elif isinstance(value, list):
            fields[f.name] = tuple(value)
    return cls(**fields)


def _nested_type(cls, name: str):
    """The dataclass a nested config field holds, from its annotation
    (``Optional[MoeConfig]`` -> ``MoeConfig``)."""
    hint = typing.get_type_hints(cls)[name]
    for candidate in (hint,) + typing.get_args(hint):
        if dataclasses.is_dataclass(candidate):
            return candidate
    raise ValueError(f"{cls.__name__}.{name} holds no nested config")


def _is_quantized(tree) -> bool:
    if isinstance(tree, dict):
        return any(str(k).endswith("_q") and torch.is_tensor(v)
                   or _is_quantized(v) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return any(_is_quantized(v) for v in tree)
    return False


def _write_json(path: str, obj: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())


def save_pretrained(directory: str, params: Any, config: Any) -> None:
    """Write ``config.json`` and the params to ``directory`` (created if
    needed), replacing any bundle there as one unit."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    config_json = config_to_json(config)
    if _is_quantized(params):
        # A weight-only int8 bundle (models/quantization.py).
        config_json["quantized"] = True
    bundle_dir = os.path.join(directory, "bundle")
    staging = bundle_dir + ".saving"
    retired = bundle_dir + ".old"
    # States on the way: the old bundle intact -> the old one retired and
    # the new one staged (both complete; for one rename's width there is
    # no live bundle, a clean load failure) -> the new bundle live.
    if os.path.exists(staging):
        shutil.rmtree(staging)
    if os.path.exists(retired):
        if not os.path.exists(bundle_dir):
            # An earlier save died between the two renames: bundle.old is
            # the only complete copy, so finish that swap first.
            os.rename(retired, bundle_dir)
        else:
            shutil.rmtree(retired)
    os.makedirs(staging)
    manager = CheckpointManager(os.path.join(staging, "params"),
                                max_to_keep=1, device="cpu")
    try:
        if not manager.save(0, params):
            raise RuntimeError(f"params were not saved to {staging}")
        manager.wait()
    finally:
        manager.close()
    _write_json(os.path.join(staging, "config.json"), config_json)
    if os.path.exists(bundle_dir):
        os.rename(bundle_dir, retired)
    os.rename(staging, bundle_dir)
    shutil.rmtree(retired, ignore_errors=True)
    # A directory in the layout from before the swap: its top-level
    # params/ is superseded, and the loader's fallback must not find it.
    legacy_params = os.path.join(directory, "params")
    if os.path.isdir(legacy_params):
        shutil.rmtree(legacy_params, ignore_errors=True)
    # The top-level config.json is a readable copy (the loader prefers the
    # bundle's own); refreshed last, atomically.
    tmp_config = os.path.join(directory, "config.json.tmp")
    _write_json(tmp_config, config_json)
    os.replace(tmp_config, os.path.join(directory, "config.json"))


def load_pretrained(directory: str, *, template: Optional[Any] = None,
                    device=None) -> Tuple[Any, Any]:
    """Read a bundle back: ``(params, config)``.

    Without ``template`` the saved tree comes back as it was saved (int8
    leaves of a quantized bundle included) with its tensors on ``device``
    (``cuda`` by default, ``"cpu"`` when asked); with one, each leaf takes
    the template's device and must match its shape and type."""
    device = resolve_device(device)
    directory = os.path.abspath(directory)
    bundle_dir = os.path.join(directory, "bundle")
    if os.path.isdir(bundle_dir):
        config_path = os.path.join(bundle_dir, "config.json")
        params_root = os.path.join(bundle_dir, "params")
    else:
        # bundle.old without bundle/ means a save died between the two
        # renames: the top-level files (if any) are older than it.  A
        # bundle.saving leftover alone does not block the fallback: a crash
        # while staging leaves the earlier layout intact.
        if os.path.exists(os.path.join(directory, "bundle.old")):
            raise RuntimeError(
                f"{directory} has an interrupted save (bundle.old "
                "present, bundle/ missing); recover by renaming "
                "bundle.old back to 'bundle'"
            )
        config_path = os.path.join(directory, "config.json")
        params_root = os.path.join(directory, "params")
    with open(config_path, encoding="utf-8") as f:
        config = config_from_json(json.load(f))
    manager = CheckpointManager(params_root, max_to_keep=1, device=device)
    try:
        params = manager.restore(0, template=template)
    finally:
        manager.close()
    return params, config
