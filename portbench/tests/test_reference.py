"""The reference: its ResNet-50 is the port's at f32, its search is brute
force in float64, and its judgement catches a planted fault."""

import numpy as np
import torch

from portbench import data
from portbench.reference import resnet50 as R
from portbench.reference import search as S


def test_the_reference_backbone_is_the_ports_in_f32():
    from image_search_engine_tpu_torch.models.embedder import CNNEmbedder

    sd = data.resnet50_weights(3, "cpu")
    imgs = data.images(3, 3, 48, "cpu")
    ref = R.ResNet50(sd, "cpu")(imgs)
    port = CNNEmbedder("resnet50", image_size=48, dtype=torch.float32, device="cpu",
                       state_dict=sd).embed_batch(imgs.numpy())
    err = (torch.from_numpy(port) - ref).norm(dim=1) / ref.norm(dim=1)
    assert float(err.max()) < 1e-5


def test_a_bf16_backbone_and_the_fp8_control_read_apart():
    """The served precision sits well inside the fp8 control's error."""
    from image_search_engine_tpu_torch.models.embedder import CNNEmbedder

    sd = data.resnet50_weights(4, "cpu")
    imgs = data.images(4, 3, 48, "cpu")
    ref = R.ResNet50(sd, "cpu")(imgs)
    bf16 = torch.from_numpy(CNNEmbedder("resnet50", image_size=48, device="cpu",
                                        state_dict=sd).embed_batch(imgs.numpy()))
    fp8 = R.ResNet50(sd, "cpu", fp8=True)(imgs)
    rel = lambda e: float(((e - ref).norm(dim=1) / ref.norm(dim=1)).max())  # noqa: E731
    assert rel(bf16) * 4 < rel(fp8)


def _case(seed=0, n=3000, d=16, q=5, k=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    qs = torch.randn(q, d, generator=g)
    return x, qs, k


def test_exact_knn_is_brute_force():
    x, q, k = _case()
    full = ((q.double()[:, None, :] - x.double()[None]) ** 2).sum(-1)
    want_d, want_i = torch.topk(full, k, largest=False)
    blocks = [(s, x[s:s + 700]) for s in range(0, len(x), 700)]
    best, ids, probe = S.exact_knn(q, (q.double() ** 2).sum(1), blocks, k, probe=want_i)
    assert torch.equal(ids, want_i)
    assert torch.allclose(best, want_d) and torch.allclose(probe, want_d)


def test_judge_reads_sound_answers_as_0_and_catches_faults():
    x, q, k = _case(1)
    blocks = [(s, x[s:s + 1000]) for s in range(0, len(x), 1000)]
    best, ids, _ = S.exact_knn(q, (q.double() ** 2).sum(1), blocks, k)

    def judged(d, i):
        _, _, probe = S.exact_knn(q, (q.double() ** 2).sum(1), blocks, k, probe=i)
        return S.judge(d, i, best, probe, len(x))

    sound = judged(best.float(), ids)
    assert sound["rank_gap"] == 0 and sound["dist_err"] < 1e-6 and sound["bad_ids"] == 0
    swapped = ids.clone()
    swapped[0, 0] = (ids[0, 0] + 1) % len(x)  # another row in its place
    assert judged(best.float(), swapped)["rank_gap"] > 1e-3
    wrong = best.float().clone()
    wrong[2, 1] *= 1.01
    assert judged(wrong, ids)["dist_err"] > 1e-3
    twice = ids.clone()
    twice[1, 1] = twice[1, 0]
    assert judged(best.float(), twice)["bad_ids"] == 1
    assert judged(best.float(), torch.full_like(ids, -1))["bad_ids"] > 0
    assert np.isinf(judged(best.float(), torch.full_like(ids, -1))["rank_gap"])
