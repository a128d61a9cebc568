"""The k-means assignment of the port on tensor cores with a 3xTF32 split
(image_search_engine_tpu_torch/ops/kmeans.py ``assign``, ``tf32_split``;
``csrc/kmeans_assign.cu``).

The kernel runs only on the card, where ``chip_smoke.py`` holds it to its
plain version with ``check_assign``'s tolerance, 4 sqrt(d) eps32 (|x| +
|c|)^2 (largest norms), codes differing only where the plain version's best
two distances lie within twice that. Here:

  (a) the split the wrapper applies to the centroids and the kernel to the
      points: hi and lo carry at most 10 explicit mantissa bits (rounded to
      nearest, ties away from zero), and hi + lo reproduces the input within
      2^-22 relative (normal inputs), within 2^-137 absolute (subnormals:
      the tf32 grid there is 2^-136), exactly for zeros;
  (b) the kernel's arithmetic emulated on the CPU (each 8-deep k-step adds
      hi.lo, then lo.hi, then hi.hi into an f32 accumulator, each partial
      product exact) against a float64 product, held to ``check_assign``'s
      tolerance and its near-tie rule, on seeded data with duplicated and
      one-ulp-apart centroids (duplicates must go to the lower index);
  (c) the routing, with a fake kernel library and ``_on_cuda`` patched: the
      pointers, batch and strides of 2-D, batched and strided PQ views, the
      centroids' halves, zero-padded copies for rows that are not whole
      16-byte units or not 16-byte aligned, a failed launch raises, and CPU
      tensors never launch;
  (d) the port's ``assign`` on the CPU (the plain version) and the emulated
      kernel arithmetic against the JAX package's ``assign_jax`` and
      ``assign_pallas`` (interpret mode) at ``test_torch_port_kmeans.py``'s
      shapes: plain codes equal and distances within rtol 1e-5 / atol 1e-4
      (f32 on both sides, another summation order); the emulation within
      ``check_assign``'s tolerance and near-tie rule.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.ops import kmeans as jax_kmeans
from image_search_engine_tpu.ops.kmeans_pallas import assign_pallas
from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops import kmeans as KM

RTOL, ATOL = 1e-5, 1e-4
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def bits(v: torch.Tensor) -> np.ndarray:
    return v.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# (a) the split
# ---------------------------------------------------------------------------


def split_inputs():
    rng = np.random.default_rng(0)
    normal = np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096),
        rng.standard_normal(64) * 1e37, [3.3e38, -3.3e38, 1.0, -1.0, 1 + 2 ** -11,
                                         -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                                         np.finfo(np.float32).tiny]])
    subnormal = np.array([1e-40, -1e-40, 2 ** -149, 3 * 2 ** -140, -1.1754e-38, 5e-42])
    return (torch.from_numpy(normal.astype(np.float32)),
            torch.from_numpy(subnormal.astype(np.float32)))


def test_split_halves_are_tf32():
    for v in split_inputs():
        hi, lo = KM.tf32_split(v)
        assert hi.dtype == lo.dtype == torch.float32
        assert not (bits(hi) & 0x1FFF).any() and not (bits(lo) & 0x1FFF).any()
        assert bool(torch.isfinite(hi).all()) and bool(torch.isfinite(lo).all())


def test_split_reproduces_its_input():
    normal, subnormal = split_inputs()
    for v, rel, absolute in ((normal, 2.0 ** -22, 0.0), (subnormal, 0.0, 2.0 ** -137)):
        hi, lo = KM.tf32_split(v)
        v64 = v.double()
        err = (hi.double() + lo.double() - v64).abs()
        assert bool((err <= rel * v64.abs() + absolute).all())


def test_split_rounds_to_nearest_ties_away_from_zero():
    v = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11, 1 + 2 ** -11 - 2 ** -23,
                      0.0, -0.0], dtype=torch.float32)
    hi, lo = KM.tf32_split(v)
    assert hi.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 * 2 ** -10, 1.0, 0.0, -0.0]
    assert lo.tolist()[:3] == [-2 ** -11, 2 ** -11, -2 ** -11]
    assert bits(hi)[5] == 0x80000000 and not lo[4:].any()


# ---------------------------------------------------------------------------
# (b) the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------


def emulated_partial(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """(N, K) f32 ``fmaf(-2, dot, |c|^2)`` as the kernel computes it: both
    operands split, d zero-padded to 8-deep k-steps, each k-step adding
    hi_x.lo_c, then lo_x.hi_c, then hi_x.hi_c (each 8-term product exact in
    float64) into an f32 accumulator."""
    pad = (-x.shape[1]) % 8
    x, c = np.pad(x, ((0, 0), (0, pad))), np.pad(c, ((0, 0), (0, pad)))
    xh, xl = (t.numpy().astype(np.float64) for t in KM.tf32_split(torch.from_numpy(x)))
    ch, cl = (t.numpy().astype(np.float64) for t in KM.tf32_split(torch.from_numpy(c)))
    acc = np.zeros((x.shape[0], c.shape[0]), np.float32)
    for s in range(0, x.shape[1], 8):
        for a, b in ((xh, cl), (xl, ch), (xh, ch)):
            acc = (acc + a[:, s:s + 8] @ b[:, s:s + 8].T).astype(np.float32)
    cn = (c.astype(np.float32) ** 2).sum(1, dtype=np.float32)
    return (cn[None, :].astype(np.float64) - 2.0 * acc).astype(np.float32)


def assert_within_check_assign(x, c, codes, partial):
    """chip_smoke's check_assign against a float64 product: distances
    within 4 sqrt(d) eps32 (|x| + |c|)^2, codes equal but where the best
    two float64 distances lie within twice that."""
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    truth = (c64 ** 2).sum(1)[None, :] - 2.0 * x64 @ c64.T
    tol = 4 * np.sqrt(x.shape[1]) * EPS32 * (np.linalg.norm(x, axis=1).max()
                                             + np.linalg.norm(c, axis=1).max()) ** 2
    best = partial[np.arange(len(codes)), codes]
    assert np.abs(best - truth.min(1)).max() <= tol
    bad = codes != truth.argmin(1)
    if bad.any():
        top2 = np.sort(truth[bad], axis=1)[:, :2]
        assert (top2[:, 1] - top2[:, 0]).max() <= 2 * tol
    return tol


def first_argmin(partial):
    return partial.argmin(1)  # numpy's argmin takes the first of equal minima


@pytest.mark.parametrize("n,k,d", [(512, 64, 2048), (300, 37, 130), (200, 256, 128)])
def test_emulated_product_within_check_assign(n, k, d):
    rng = np.random.default_rng(n + k + d)
    x = (rng.standard_normal((n, d)) * 3).astype(np.float32)
    c = (rng.standard_normal((k, d)) * 3).astype(np.float32)
    c[1] = c[0]  # an exact duplicate: the lower index wins
    c[3] = np.nextafter(c[2], np.float32(np.inf))  # one ulp apart in every coordinate
    x[:8] = c[:8] + 1e-3 * rng.standard_normal((8, d)).astype(np.float32)
    part = emulated_partial(x, c)
    codes = first_argmin(part)
    assert_within_check_assign(x, c, codes, part)
    assert not (codes == 1).any()  # never the duplicate's higher index
    assert np.array_equal(part[:, 0], part[:, 1])


# ---------------------------------------------------------------------------
# (c) routing
# ---------------------------------------------------------------------------


class FakeLibrary:
    """Records each entry point's arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def ise_error_string(self, err):
        return b"fake error"

    def __getattr__(self, name):
        if not name.startswith("ise_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    """A fake kernel library behind ``assign``, which takes CPU tensors for
    CUDA ones; the halves the wrapper passes are recorded."""
    def install(rc=0):
        lib = FakeLibrary(rc)
        lib.halves = []
        split = KM.tf32_split

        def recording_split(v):
            out = split(v)
            lib.halves.append(out)
            return out
        monkeypatch.setattr(_kernels, "library", lambda: lib)
        monkeypatch.setattr(KM, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(KM, "_stream", lambda t: 0)
        monkeypatch.setattr(KM, "tf32_split", recording_split)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        return lib
    return install


def launch_args(lib):
    assert [c[0] for c in lib.calls] == ["ise_kmeans_assign"]
    # x, chi, clo, cn, codes, mins, nb, n, k, d, sxb, sxn, stream
    return lib.calls[0][1]


def test_assign_routes_2d_points(fake_cuda):
    lib = fake_cuda()
    g = torch.Generator().manual_seed(0)
    x, c = torch.randn(300, 64, generator=g), torch.randn(10, 64, generator=g)
    before = KM.assign.launches
    codes, dists = KM.assign(x, c)
    assert KM.assign.launches == before + 1 and codes.shape == dists.shape == (300,)
    args = launch_args(lib)
    hi, lo = lib.halves[0]
    assert args[0] == x.data_ptr() and args[1:3] == (hi.data_ptr(), lo.data_ptr())
    assert args[6:12] == (1, 300, 10, 64, 300 * 64, 64)
    want_hi, want_lo = KM.tf32_split(c)
    assert torch.equal(hi.view(10, 64), want_hi) and torch.equal(lo.view(10, 64), want_lo)


def test_assign_routes_the_pq_books_strided_view(fake_cuda):
    lib = fake_cuda()
    g = torch.Generator().manual_seed(1)
    resid = torch.randn(200, 4, 16, generator=g)
    books = torch.randn(4, 11, 16, generator=g)
    view = resid.transpose(0, 1)  # (m, N, dsub), no copy
    codes, _ = KM.assign(view, books)
    assert codes.shape == (4, 200)
    args = launch_args(lib)
    assert args[0] == resid.data_ptr()  # read in place
    assert args[6:12] == (4, 200, 11, 16, 16, 64)
    assert torch.equal(lib.halves[0][0], KM.tf32_split(books)[0])


def test_assign_pads_rows_of_no_whole_16_byte_units(fake_cuda):
    lib = fake_cuda()
    g = torch.Generator().manual_seed(2)
    resid = torch.randn(200, 3, 7, generator=g)
    books = torch.randn(3, 5, 7, generator=g)
    KM.assign(resid.transpose(0, 1), books)
    args = launch_args(lib)
    # a zero-padded contiguous copy (3, 200, 8), the centroids padded alike
    assert args[0] != resid.data_ptr() and args[6:12] == (3, 200, 5, 8, 1600, 8)
    hi, lo = lib.halves[0]
    assert hi.shape == (3, 5, 8) and not hi[..., 7].any() and not lo[..., 7].any()
    assert torch.equal(hi[..., :7], KM.tf32_split(books)[0])


def test_assign_copies_misaligned_points(fake_cuda):
    lib = fake_cuda()
    g = torch.Generator().manual_seed(3)
    buf = torch.randn(101 * 64 + 1, generator=g)
    x = buf[1:].view(101, 64)  # rows start 4 bytes past a 16-byte boundary
    KM.assign(x, torch.randn(9, 64, generator=g))
    args = launch_args(lib)
    assert args[0] != x.data_ptr() and args[0] % 16 == 0
    assert args[6:12] == (1, 101, 9, 64, 101 * 64, 64)


def test_a_failed_assign_launch_raises(fake_cuda):
    fake_cuda(rc=1)
    before = KM.assign.launches
    with pytest.raises(RuntimeError, match="kmeans_assign kernel launch failed"):
        KM.assign(torch.randn(50, 16), torch.randn(4, 16))
    assert KM.assign.launches == before


def test_cpu_tensors_never_launch(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    before = KM.assign.launches
    g = torch.Generator().manual_seed(4)
    x, c = torch.randn(80, 12, generator=g), torch.randn(6, 12, generator=g)
    codes, dists = KM.assign(x, c)
    assert lib.calls == [] and KM.assign.launches == before
    rc, rd = KM.assign_ref(x, c)
    assert torch.equal(codes, rc) and torch.equal(dists, rd)


# ---------------------------------------------------------------------------
# (d) against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,k", [(300, 20, 13), (257, 64, 8), (64, 3, 70)])
def test_assign_and_its_kernel_arithmetic_match_jax(n, d, k):
    rng = np.random.default_rng(n + d + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    codes, dists = KM.assign(torch.from_numpy(x), torch.from_numpy(c))
    part = emulated_partial(x, c)
    ecodes = first_argmin(part)
    tol = assert_within_check_assign(x, c, ecodes, part)
    xn = (x.astype(np.float64) ** 2).sum(1)
    for jc, jd in (jax_kmeans.assign_jax(jnp.asarray(x), jnp.asarray(c)),
                   assign_pallas(jnp.asarray(x), jnp.asarray(c), interpret=True)):
        jc, jd = np.asarray(jc), np.asarray(jd)
        np.testing.assert_array_equal(codes.numpy(), jc)
        np.testing.assert_allclose(dists.numpy(), jd, rtol=RTOL, atol=ATOL)
        edist = np.maximum(part[np.arange(n), ecodes] + xn, 0.0)
        assert np.abs(edist - jd).max() <= 2 * tol
        assert ((ecodes == jc) | (np.abs(edist - jd) <= 2 * tol)).all()
