"""The port's copy of ``examples/generate_text.py``: train CloudLM TINY on
a character corpus, then decode ragged prompts greedily, by nucleus
sampling, by a 4-beam search and with int8 weights (``quantize_params``;
once more with the int8 KV cache as well).

Training runs K5-K7 (the flash forward and backward); decoding runs the
paged kernel K8, and K8q under ``kv_quant``.  ``main(device=...)``: the
card by default.
"""

import functools

import numpy as np
import torch

CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "pack my box with five dozen liquor jugs. "
    "how vexingly quick daft zebras jump! "
) * 40


def _text(row) -> str:
    return bytes(int(c) for c in row).decode(errors="replace")


def main(device=None):
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import generation, quantization, transformer
    from cloud_tpu_torch.training import Trainer, data, optimizers

    vocab = 128  # raw ascii
    config = transformer.TINY.scaled(vocab_size=vocab, max_seq_len=64)
    seq_len = 32

    # Character-level windows over the corpus.
    codes = np.frombuffer(CORPUS.encode(), np.uint8).astype(np.int32)
    starts = np.arange(0, len(codes) - seq_len - 1, 7)
    tokens = np.stack([codes[s:s + seq_len] for s in starts])

    trainer = Trainer(
        functools.partial(transformer.loss_fn, config=config, device=device),
        optimizers.adamw(3e-3),
        init_fn=lambda gen: bridge.init(config, gen, device="cpu"),
        device=device,
    )
    trainer.init_state(torch.Generator().manual_seed(0))
    ds = data.ArrayDataset({"tokens": tokens}, batch_size=32, shuffle=True)
    hist = trainer.fit(ds, epochs=3)
    losses = hist.history["loss"]
    print(f"train loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0]

    # Ragged prompts, batched generation.
    prompts = ["the quick brown ", "pack my "]
    t_prompt = max(len(p) for p in prompts)
    prompt_tokens = np.zeros((len(prompts), t_prompt), np.int32)
    prompt_lens = np.asarray([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        prompt_tokens[i, : len(p)] = np.frombuffer(p.encode(), np.uint8)

    params = bridge.map_leaves(trainer.state.params, lambda t: t.detach())
    texts = {}
    for name, sample in [
        ("greedy", generation.SampleConfig(temperature=0.0)),
        ("nucleus", generation.SampleConfig(temperature=0.8, top_p=0.9)),
    ]:
        out = generation.generate(
            params, prompt_tokens, prompt_lens, config, max_new_tokens=24,
            sample=sample,
            generator=torch.Generator(device=trainer.device).manual_seed(1),
            device=trainer.device,
        )
        texts[name] = []
        for i, p in enumerate(prompts):
            n_real = int(prompt_lens[i]) + 24
            text = _text(out["sequences"][i][:n_real].tolist())
            texts[name].append(text)
            print(f"{name:8s} | {text!r}")

    beam = generation.beam_search(
        params, prompt_tokens, prompt_lens, config, num_beams=4,
        max_new_tokens=24, device=trainer.device,
    )
    for i, p in enumerate(prompts):
        text = _text(c for c in beam["tokens"][i].tolist() if c)
        print(f"beam-4   | {p + text!r}  (score "
              f"{float(beam['scores'][i]):.3f})")

    # Serving-weight quantization: int8 storage (~4x smaller); on a
    # trained model greedy output stays essentially the same.
    qparams = quantization.quantize_params(params)
    ratio = (quantization.param_bytes(qparams)
             / quantization.param_bytes(params))
    for name, kv_quant in (("int8", False), ("int8+kv", True)):
        qout = generation.generate(
            qparams, prompt_tokens, prompt_lens, config, max_new_tokens=24,
            kv_quant=kv_quant, device=trainer.device,
        )
        text = _text(qout["sequences"][0][: int(prompt_lens[0]) + 24]
                     .tolist())
        texts[name] = [text]
        print(f"{name:8s} | {text!r}  (params {ratio:.2f}x of full)")
    trainer.texts = texts
    return trainer


if __name__ == "__main__":
    main()
