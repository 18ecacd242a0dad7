"""Import hygiene of the PyTorch port.

Every module of ``cloud_tpu_torch`` imports with JAX blocked; no module of
the port, nor ``chip_smoke.py``, ``flash_ab.py`` or ``gn_ab.py``, imports
``jax`` or the JAX package; and an entry point called without
``device="cpu"`` on a host with no card raises instead of quietly running
on the CPU.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cloud_tpu_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    modules = list(_port_modules())
    assert len(modules) >= 14
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from cloud_tpu_torch.ops import dispatch\n"
        "assert not dispatch._libs, 'a kernel library was loaded at import'\n"
        "bad = [m for m in sys.modules if m == 'cloud_tpu' "
        "or m.startswith('cloud_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "flash_ab.py",
                                          REPO / "gn_ab.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "cloud_tpu"), (
            f"{path.name} imports {name}")


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device resolves")
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import bert, generation, resnet, transformer
    from cloud_tpu_torch.serving import ServingEngine
    from cloud_tpu_torch.training import optimizers, train
    from cloud_tpu_torch.utils import benchmarking

    cfg = transformer.TINY.scaled(dtype=torch.float32, num_layers=1)
    params = bridge.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = [
        lambda: bridge.init(cfg, torch.Generator()),
        lambda: transformer.apply(params, torch.ones((1, 4), dtype=torch.long),
                                  cfg),
        lambda: generation.generate(params, torch.ones((1, 4)),
                                    torch.tensor([4]), cfg,
                                    max_new_tokens=2),
        lambda: generation.init_slot_cache(cfg, 2, 8),
        lambda: generation.init_slot_cache(cfg, 2, 8, kv_quant=True),
        lambda: generation.beam_search(params, torch.ones((1, 4)),
                                       torch.tensor([4]), cfg, num_beams=2,
                                       max_new_tokens=2),
        lambda: benchmarking.decode_tokens_per_sec(
            params, cfg, torch.ones((1, 4)), torch.tensor([4]),
            max_new_tokens=2),
        lambda: ServingEngine(params, cfg, start=False),
        lambda: benchmarking.decode_setup(),
        lambda: bridge.init_resnet(resnet.RESNET8_CIFAR, torch.Generator()),
        lambda: resnet.apply({}, torch.zeros((1, 32, 32, 3)),
                             resnet.RESNET8_CIFAR),
        lambda: train.create_sharded_state(None, dict, optimizers.sgd(0.1)),
        lambda: benchmarking.resnet_train_setup(imagenet_shape=False,
                                                batch_size=2),
        lambda: transformer.loss_fn(params, {"tokens": torch.ones((1, 4))},
                                    cfg),
        lambda: benchmarking.lm_train_setup(batch_size=1, seq_len=4,
                                            config=cfg),
        lambda: bridge.init_bert(bert.TINY, torch.Generator()),
        lambda: bert.apply({}, torch.ones((1, 4)), bert.TINY),
        lambda: benchmarking.bert_train_setup(batch_size=1, seq_len=4,
                                              config=bert.TINY),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
