"""Entry point twin of the repo's ``__graft_entry__.entry()``.

``entry()`` returns ``(fn, example_args)`` for the flagship model's forward
step: the ResNet-50 embedder (preprocess + backbone -> 2048-D embeddings),
the serving path's per-query compute, at batch 8 and 224 px; any other
backbone of ``models/embedder.MODEL_REGISTRY`` by name. It runs on the card
unless the caller asks for the CPU.

    python -m image_search_engine_tpu_torch.graft_entry [--model densenet121] [--device cpu]
"""

from __future__ import annotations


def entry(device="cuda", model_name: str = "resnet50", image_size: int = 224,
          batch_size: int = 8):
    """(fn, example_args): ``fn(images)`` maps a (B, size, size, 3) f32
    batch in [0, 1] on ``device`` to (B, dim) f32 embeddings there (the
    weights live in the module, random-init from seed 0, bf16 as served);
    ``example_args`` holds a zero batch."""
    import torch

    from image_search_engine_tpu_torch.models.embedder import CNNEmbedder

    emb = CNNEmbedder(model_name, image_size=image_size, batch_size=batch_size, device=device)
    images = torch.zeros((batch_size, image_size, image_size, 3), dtype=torch.float32,
                         device=emb.device)
    return emb.embed, (images,)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--model", default="resnet50")
    a = ap.parse_args()
    fn, args = entry(a.device, a.model)
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
