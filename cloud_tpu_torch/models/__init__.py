"""The model zoo in PyTorch (port of ``cloud_tpu/models``).

CloudLM (``transformer``, with the MoE MLP of ``moe``), BERT (``bert``),
ViT (``vit``), ResNet (``resnet``) and MNIST (``mnist``) over the shared
``layers``; ``generation`` decodes CloudLM, ``quantization`` makes its
weight-only int8 trees, and ``export`` saves and loads pretrained bundles
of every family but MNIST.
"""

__all__ = ["bert", "export", "generation", "layers", "mnist", "moe",
           "quantization", "resnet", "transformer", "vit"]
