"""Entry point twins of the repo's ``__graft_entry__.py``.

``entry()`` returns ``(fn, example_args)`` for the flagship model's forward
step: the ResNet-50 embedder (preprocess + backbone -> 2048-D embeddings),
the serving path's per-query compute, at batch 8 and 224 px; any other
backbone of ``models/embedder.MODEL_REGISTRY`` by name.

``dryrun_multichip(n)`` runs the multi-device path at tiny shapes on a mesh
of n shards of one device (the JAX function's n virtual CPU devices):
its steps, and the two serving families it leaves out. Both run on the
card unless the caller asks for the CPU.

    python -m image_search_engine_tpu_torch.graft_entry [--model densenet121] [--device cpu]
"""

from __future__ import annotations

import numpy as np


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


def _dp_step(mesh, home, rng, workdir) -> float:
    """Step 1: one data-parallel train step (densenet-tiny, 32 px, batch
    2n, unfrozen, triplet; f32 with TF32 off). Its loss is held to the
    unsharded step's at ``step_compare.STEP_BOUNDS``; the state is not: over these
    noise images at batch 2 the unsharded f32 step itself lies outside those
    bounds of a float64 step (the CPU tests and ``chip_smoke.py`` hold the
    whole state on spread batches). Saves the checkpoint that the siamese
    family serves."""
    from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig
    from image_search_engine_tpu_torch.training.siamese.step_compare import (
        STEP_BOUNDS, replicas_equal, step_gap)
    from image_search_engine_tpu_torch.training.siamese.train import Trainer

    batch = 2 * mesh.size
    cfg = SiameseConfig(backbone="densenet-tiny", image_size=(32, 32), embedding_dim=16,
                        batch_size=batch, freeze_backbone=False, loss="triplet",
                        compute_dtype="f32", ckpt_dir=workdir / "ckpts",
                        log_file=workdir / "metrics.jsonl")
    anchors = rng.random((batch, 32, 32, 3)).astype(np.float32)
    negatives = rng.random((batch, 32, 32, 3)).astype(np.float32)
    sharded, one = Trainer(cfg, mesh=mesh), Trainer(cfg, device=home)
    loss = float(sharded.train_step(anchors, negatives))
    gap = step_gap(one, sharded, float(one.train_step(anchors, negatives)), loss)
    assert np.isfinite(loss), f"non-finite training loss {loss}"
    assert gap["loss"] <= 1.0, f"the sharded step's loss is not the unsharded one's: {gap} " \
                               f"(over {STEP_BOUNDS})"
    assert replicas_equal(sharded)
    sharded.save_checkpoint(0, loss)
    return loss


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The multi-device path on ``Mesh([home] * n_devices)``, tiny shapes:
      1. one data-parallel siamese train step, its loss the unsharded one's;
      2. the sharded exact flat search, and ``distributed_topk`` with its
         certificate (all true) and the index's ids;
      3. sharded chi2: each query matches itself;
      4. distributed k-means (``kmeans_fit_sharded``);
      5. ``ShardedIVF``;
      6. ``ShardedIVFPQ``: with its exact rerank, ADC only, and
         ``search_batched``;
      7. the BoVW prologue (describe -> assign -> histogram -> BM25) feeding
         the certified ``distributed_topk``;
      8. a ``QueryEngine(mesh=)`` query over 8 indexed PNGs;
    then the families the JAX function leaves out: ``create_index(mesh=)``
    over step 1's checkpoint, served by ``SiameseQueryEngine``; and a dHash
    engine made with the mesh (dHash never shards). Prints one line and
    returns what it checked, with each kernel's launches over the run."""
    import tempfile
    from pathlib import Path

    import torch
    from PIL import Image

    from image_search_engine_tpu_torch.config import (
        Config, CornerDescriptorKind, DnnModel, IndexType, Method)
    from image_search_engine_tpu_torch.descriptors import make_descriptor
    from image_search_engine_tpu_torch.engine import QueryEngine
    from image_search_engine_tpu_torch.index.flat import FlatIndex
    from image_search_engine_tpu_torch.index.ivf import IVFPQIndex
    from image_search_engine_tpu_torch.indexer import main as indexer_main
    from image_search_engine_tpu_torch.ops.bm25 import bm25_transform
    from image_search_engine_tpu_torch.ops.distances import l2_normalize
    from image_search_engine_tpu_torch.ops.histogram import batched_histograms
    from image_search_engine_tpu_torch.ops.kmeans import assign, centroid_split
    from image_search_engine_tpu_torch.parallel.ivf import ShardedIVF, ShardedIVFPQ
    from image_search_engine_tpu_torch.parallel.kmeans import kmeans_fit_sharded
    from image_search_engine_tpu_torch.parallel.mesh import Mesh, make_mesh
    from image_search_engine_tpu_torch.parallel.topk import distributed_topk
    from image_search_engine_tpu_torch.serving.fused import launch_counters
    from image_search_engine_tpu_torch.training.siamese.config import SiameseConfig
    from image_search_engine_tpu_torch.training.siamese.create_index import create_index
    from image_search_engine_tpu_torch.training.siamese.serve import SiameseQueryEngine
    from image_search_engine_tpu_torch.utils.imageio import load_image

    home = make_mesh(1, device).home
    mesh = Mesh([home] * n_devices)
    rng = np.random.default_rng(0)
    before = launch_counters()
    work = Path(tempfile.mkdtemp(prefix="ise_dryrun_"))
    try:
        # 1) data-parallel training step
        loss = _dp_step(mesh, home, rng, work / "siamese")

        # 2) sharded exact search; the certificate survives the mesh
        x = rng.standard_normal((16 * n_devices + 3, 32)).astype(np.float32)
        q = rng.standard_normal((4, 32)).astype(np.float32)
        idx = FlatIndex("l2", mesh=mesh).add(x)
        d, i = idx.search(q, 5)
        assert i.max() < x.shape[0] and np.isfinite(d).all()
        store = idx.store
        _, ii, cert = distributed_topk(torch.from_numpy(q).to(home), store.vectors,
                                       store.norms, 5, "l2", mesh, with_certificate=True)
        cert = cert.cpu().numpy()
        assert cert.shape == (4,) and cert.all(), f"certificate failed: {cert}"
        np.testing.assert_array_equal(ii.cpu().numpy(), i)

        # 3) sharded chi2 (histogram metric, chunked scan per shard)
        hists = rng.random((16 * n_devices + 3, 32)).astype(np.float32)
        _, ich = FlatIndex("chi2", mesh=mesh).add(hists).search(hists[:4] + 0.01, 3)
        assert (ich[:, 0] == np.arange(4)).all(), f"chi2 self-match failed: {ich}"

        # 4) distributed k-means
        c, inertia = kmeans_fit_sharded(x, 4, mesh, niter=3, nredo=1)
        assert np.isfinite(float(inertia)) and tuple(c.shape) == (4, 32)

        # 5) sharded IVF
        _, i2 = ShardedIVF.from_components(x, c, nprobe=2, mesh=mesh).search(q, 3)
        assert (i2 < x.shape[0]).all()

        # 6) sharded IVF-PQ: per-shard packed codes, replicated books
        spq = ShardedIVFPQ.from_index(IVFPQIndex(nlist=4, nprobe=4, m=8, rerank=8,
                                                 device=home).add(x), mesh)
        d3, i3 = spq.search(q, 3)
        assert (i3 < x.shape[0]).all() and np.isfinite(d3).all()
        assert np.isfinite(spq.search(q, 3, rerank=0)[0]).all()
        d3b, i3b = spq.search_batched(q, 3)
        assert (i3b < x.shape[0]).all() and np.isfinite(d3b).all()

        # 7) the BoVW prologue into the certified distributed top-k
        nclusters = 16
        desc = make_descriptor(Config(
            method=Method.BOVW, corner_descriptor=CornerDescriptorKind.DAISY,
            resize_size=48, daisy_step=16, daisy_radius=16), device=home)
        imgs = torch.from_numpy(rng.random((2, 48, 48, 3)).astype(np.float32)).to(home)
        feats, valid = desc.describe_device(imgs)
        b, kp, dd = feats.shape
        cents = torch.from_numpy(
            rng.standard_normal((nclusters, dd)).astype(np.float32)).to(home)
        hidx = FlatIndex("cosine", mesh=mesh).add(
            rng.random((16 * n_devices + 3, nclusters)).astype(np.float32))
        codes, _ = assign(feats.reshape(-1, dd).float().contiguous(), cents,
                          centroid_split(cents) if home.type == "cuda" else None)
        w = l2_normalize(bm25_transform(batched_histograms(codes.reshape(b, kp), valid,
                                                           nclusters), 1.0, 1.0, 0.75))
        _, ib, certb = distributed_topk(w, hidx.store.vectors, hidx.store.norms, 3, "ip",
                                        mesh, with_certificate=True)
        certb = certb.cpu().numpy()
        assert certb.all() and (ib >= 0).all(), certb

        # 8) an engine query on the mesh: indexer artifacts, then QueryEngine
        img_dir = work / "images"
        img_dir.mkdir()
        for j in range(8):
            Image.fromarray((rng.random((48, 48, 3)) * 255).astype(np.uint8)).save(
                img_dir / f"im{j}.png")
        ecfg = Config(data_dir=img_dir, artifacts_dir=work / "artifacts", method=Method.DNN,
                      dnn_model=DnnModel.RESNET_TINY, index_type=IndexType.L2,
                      resize_size=32, embed_batch_size=4, num_images_to_return=3,
                      precompute_thumbnails=False)
        indexer_main(ecfg, device=home)
        eng = QueryEngine(ecfg, device=home, mesh=mesh, prewarm=False)
        pred = eng.query(load_image(eng.paths[1]), k=3)
        assert pred and pred[0][2] == eng.paths[1], pred

        # the siamese family: step 1's checkpoint, indexed on the mesh, served
        scfg = SiameseConfig(backbone="densenet-tiny", image_size=(32, 32), embedding_dim=16,
                             batch_size=4, ckpt_dir=work / "siamese" / "ckpts")
        create_index(scfg, img_dir, work / "siamese.index.npz", work / "siamese.csv",
                     device=home, mesh=mesh)
        seng = SiameseQueryEngine(scfg, work / "siamese.index.npz", work / "siamese.csv",
                                  n_results=3, prewarm=False, device=home)
        spred = seng.query(load_image(seng.paths[2]), k=3)
        assert spred and spred[0][2] == seng.paths[2], spred

        # dHash: an engine made with the mesh serves unsharded
        dcfg = Config(data_dir=img_dir, artifacts_dir=work / "dhash", method=Method.DHASH,
                      resize_size=32, num_images_to_return=3, precompute_thumbnails=False)
        indexer_main(dcfg, device=home)
        deng = QueryEngine(dcfg, device=home, mesh=mesh, prewarm=False)
        dpred = deng.query(load_image(deng.paths[3]), k=3)
        assert dpred and dpred[0][2] == deng.paths[3], dpred
        for e in (eng, seng, deng):
            e.close()
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    if home.type == "cuda":
        torch.cuda.synchronize()
    after = launch_counters()
    launches = {f"{fn.__name__}.{attr}": n - before.get((fn, attr), 0)
                for (fn, attr), n in after.items() if n != before.get((fn, attr), 0)}
    print(f"dryrun_multichip({n_devices}, {home}): train loss {loss:.4f} (= the unsharded "
          f"step's), sharded flat+IVF+IVFPQ search, certified distributed top-k "
          f"({int(cert.sum())}/{cert.size} exact), sharded chi2, fused sharded-BoVW "
          f"({int(certb.sum())}/{certb.size} certified), k-means, QueryEngine, siamese "
          f"create_index + serve and dHash engine queries ok ({x.shape[0]} rows, "
          f"{n_devices} shards)" + (f"; launches {launches}" if home.type == "cuda" else ""))
    return {"loss": loss, "certified": int(cert.sum()), "bovw_certified": int(certb.sum()),
            "launches": launches}


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
