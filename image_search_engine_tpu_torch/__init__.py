"""image_search_engine_tpu_torch — the image index-and-query engine in
PyTorch and CUDA for NVIDIA Hopper.

A port of ``image_search_engine_tpu`` (JAX, Pallas for TPU), which stays
beside it as the reference. Modules mirror the JAX package's layout
(``index/flat.py`` here is ``index/flat.py`` there). The port imports nothing of the JAX package,
not even its framework-free host modules: ``config``, ``utils/imageio``,
``utils/native_loader``, ``ServingStats``, the HTTP handler and the upload
page are the port's own copies. Nothing here imports jax.

The main path is ported: DNN (ResNet-50) embeddings into a flat exact index,
searched by a certified two-phase top-k whose three kernels are hand-written
CUDA (``csrc/topk_twophase.cu``), served over HTTP. Everything else raises
``NotImplementedError`` naming the ROADMAP.md item that brings it.
"""

__version__ = "0.1.0"

from image_search_engine_tpu_torch.config import Config, DnnModel, IndexType, Method  # noqa: F401
