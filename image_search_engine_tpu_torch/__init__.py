"""image_search_engine_tpu_torch — the image index-and-query engine in
PyTorch and CUDA for NVIDIA Hopper.

A port of ``image_search_engine_tpu`` (JAX, Pallas for TPU), which stays
beside it as the reference. Modules mirror the JAX package's layout
(``index/flat.py`` here is ``index/flat.py`` there). The port imports nothing of the JAX package,
not even its framework-free host modules: ``config``, ``utils/imageio``,
``utils/native_loader``, ``ServingStats``, the HTTP handler and the upload
page are the port's own copies. Nothing here imports jax.

Everything the JAX package does is ported: DNN, BoVW and dHash indexes
(flat, IVF, IVF-PQ) built and served over HTTP, every Pallas kernel as
hand-written CUDA (``csrc/``), siamese training and serving, and scale-out
over a mesh of devices and processes, data-parallel training included.
"""

__version__ = "0.1.0"

from image_search_engine_tpu_torch.config import Config, DnnModel, IndexType, Method  # noqa: F401
