"""The port's copy of ``examples/long_context_ring_attention.py``: CloudLM
TINY trained under ``{fsdp: n // 4, sp: 4}`` over the job's ranks (the
devices of the mesh the bootstrap installed: at least 4 ranks, one
process each), with the zig-zag ring, the fused cross-entropy and remat
"dots" — the long-context memory recipe: the ``[B, T, V]`` logits never
materialize and each layer saves only its matmul outputs, so activation
memory stays O(T/sp).
"""

import functools

import numpy as np
import torch


def main():
    from cloud_tpu_torch import bridge, parallel
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.training import Trainer, data, optimizers

    outer = parallel.get_global_mesh()
    if outer is None or outer.spec.num_devices < 4:
        raise RuntimeError("the ring example needs a job of at least 4 "
                           "ranks (sp = 4); run it under the bootstrap")
    n = outer.spec.num_devices
    # fsdp x sp: parameters ZeRO-sharded over fsdp, sequence over sp.
    mesh = parallel.MeshSpec({"fsdp": max(n // 4, 1), "sp": 4}).build(
        devices=list(outer.devices), backend=outer.backend)
    print(f"mesh: {[f'{a}={s}' for a, s in mesh.shape.items() if s > 1]}")

    # zigzag_sp: causal attention runs as the load-balanced zig-zag ring
    # (every rank folds the same causal mass per hop); data stays in
    # natural order — the model owns the layout permutation.
    config = transformer.TINY.scaled(
        zigzag_sp=True, fused_ce=True, remat=True, remat_policy="dots"
    )
    seq_len = 128  # divisible by 2*sp=8 -> zig-zag chunks of 16

    trainer = Trainer(
        functools.partial(transformer.loss_fn, config=config, mesh=mesh),
        optimizers.adamw(1e-3),
        init_fn=lambda gen: bridge.init(config, gen, device="cpu"),
        mesh=mesh,
        logical_axes=transformer.param_logical_axes(config),
    )
    trainer.init_state(torch.Generator().manual_seed(0))

    dataset = data.synthetic_tokens(
        vocab_size=config.vocab_size, seq_len=seq_len, batch_size=8,
        num_batches=4,
    )
    trainer.history = trainer.fit(dataset, epochs=3)
    losses = [round(x, 4) for x in trainer.history.history["loss"]]
    print(f"losses per epoch: {losses}")
    assert np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], "loss should improve"
    print("ring-attention training ran end to end")
    return trainer


if __name__ == "__main__":
    main()
