"""Run configuration: the ``Config`` dataclass and its enums.

A copy of the JAX package's ``config.py`` (the port imports nothing of that
package). Enum values are the same strings in both, so artifacts and CLI
flags are interchangeable between the packages. Nothing touches the
filesystem at import; every field can be overridden per run (constructor
kwargs, ``Config.from_env()``, or the indexer/engine CLI flags).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from pathlib import Path


# Flat-store precisions (canonical here so Config.from_env can validate
# without importing the index modules).
STORE_DTYPES = ("f32", "bf16", "int8")


class Method(enum.Enum):
    """Indexing method (reference: backend/config.py Method enum)."""

    BOVW = "bovw"
    DNN = "dnn"
    DHASH = "dhash"


class DnnModel(enum.Enum):
    """CNN embedding backbone (reference: backend/config.py DnnModels enum)."""

    RESNET = "resnet50"
    BIT = "bit-50"
    DENSENET = "densenet121"  # siamese backbone, also usable directly
    # tiny variants for tests / CI smoke runs
    RESNET_TINY = "resnet-tiny"
    BIT_TINY = "bit-tiny"
    DENSENET_TINY = "densenet-tiny"


class IndexType(enum.Enum):
    """Vector-index type (reference: backend/utils.py:293-330 INDEX_TYPE)."""

    COSINE = "cosine"  # inner-product over L2-normalized rows
    L2 = "l2"
    CHI2 = "chi2"  # chi-squared histogram distance (the reference ships
    # chi2_distance unwired, backend/utils.py:91-97; here it is a
    # first-class flat metric, natural for BoVW histograms)
    CELL_PROBE = "cell-probe"  # IVF (coarse quantizer + probed lists)
    IVFPQ = "ivfpq"  # IVF + product quantization


class CornerDescriptorKind(enum.Enum):
    """Local-descriptor family for the BoVW path.

    The reference wraps OpenCV ORB/SIFT/BRISK and skimage DAISY
    (backend/descriptors.py:31-44, 207-258); here each is a first-party
    batched JAX pipeline (see ops/corners.py, ops/daisy.py).
    """

    ORB = "orb"
    SIFT = "sift"
    BRISK = "brisk"
    DAISY = "daisy"


@dataclasses.dataclass
class Config:
    # --- paths -----------------------------------------------------------
    data_dir: Path = Path("data/images")  # corpus of jpg/jpeg/png images
    artifacts_dir: Path = Path("artifacts")  # indexes, codebooks, pipelines

    # --- method selection -------------------------------------------------
    method: Method = Method.DNN
    dnn_model: DnnModel = DnnModel.RESNET
    torch_weights: "Path | None" = None  # torchvision ResNet/DenseNet .pth
    # to import (models/torch_import.py): the reference's pretrained
    # backbones carry over — converted at startup, forward parity tested
    index_type: IndexType = IndexType.L2
    corner_descriptor: CornerDescriptorKind = CornerDescriptorKind.DAISY
    store_dtype: str = "f32"  # flat-store precision: f32 | bf16 | int8
    # (bf16/int8 cut the HBM footprint 2x/4x at ~0.994/~0.978 recall@10
    # vs f32; throughput is within ~10% across precisions — see
    # index/flat.py. The engine reads the dtype back from the saved
    # index, so this is an index-build-time choice.)

    # --- image preprocessing ----------------------------------------------
    resize_size: int = 224  # reference config.py:33 RESIZE_SIZE
    thumbnail_size: int = 256  # reference config.py:52 THUMBNAIL_SIZE

    # --- query ------------------------------------------------------------
    num_images_to_return: int = 20  # reference config.py:39
    embed_batch_size: int = 64  # batched device inference (reference ran batch=1)

    # --- BoVW / codebook ----------------------------------------------------
    num_clusters: int = 200  # reference config.py:103 NUM_CLUSTERS
    min_num_clusters: int = 20  # GridSearch sweep range (config.py:104-107)
    max_num_clusters: int = 200
    num_cluster_grid_points: int = 4
    use_cluster_grid_search: bool = False
    kmeans_niter: int = 25  # faiss.Kmeans defaults mirrored (kmeans_faiss.py:33-37)
    kmeans_nredo: int = 3
    kmeans_seed: int = 42
    kmeans_spherical: bool = True
    max_descriptors_per_image: int = 256  # fixed-size keypoint budget
    corner_n_levels: int = 4  # keypoint scale-pyramid depth (cv2 ORB: 8x1.2)
    corner_scale_step: float = 1.25
    daisy_step: int = 32  # reference descriptors.py:238-254 defaults
    daisy_radius: int = 32

    # --- BM25 (OkapiTransformer, reference utils.py:100-219) ----------------
    bm25_k1: float = 1.0
    bm25_k2: float = 1.0
    bm25_b: float = 0.75

    # --- IVF ----------------------------------------------------------------
    ivf_nlist: int = 8  # reference utils.py:317 ncentroids
    ivf_nprobe: int = 5  # reference utils.py:324
    pq_m: int = 16  # subquantizers (reference utils.py:318)
    pq_nbits: int = 8
    pq_rerank: int = 0  # exact-rerank shortlist (0 = ADC ranking only;
    # >0 keeps raw vectors in the artifact so the shortlist can be
    # re-scored exactly — faiss IndexRefineFlat composition)

    # --- cluster-quality scoring (reference utils.py:235-290) ---------------
    cluster_score_sample_size: int = 2000
    cluster_score_repeats: int = 10

    # --- serving ------------------------------------------------------------
    host: str = "127.0.0.1"
    port: int = 5000
    # batch concurrent queries (serving/batching.py): False/"off", True/"on",
    # or "auto" (measure at prewarm whether coalescing beats pipelined
    # independent dispatches on this topology and decide from the numbers)
    micro_batch: object = False
    micro_batch_max: int = 8
    micro_batch_wait_ms: float = 3.0
    precompute_thumbnails: bool = True  # pack result thumbnails at index time
    prewarm: bool = True  # build the kernels and capture the serving
    # programs (CUDA graphs) before the first request (--no-prewarm: the
    # first requests do it)
    prewarm_wide: bool = False  # also capture the WIDE-margin program the
    # certificate escalation retries with: t_margin keys its own program,
    # so without this the first escalation captures inside the request
    # path. Off by default: escalations are rare.

    # --- mesh / sharding ------------------------------------------------------
    mesh_axis: str = "data"  # 1-D mesh axis the vector store is sharded over
    shard_devices: "int | None" = None  # --sharded: shard the index over a
    # 1-D mesh of the first N local devices (0 = all). None = unsharded.
    # --- multi-host (DCN) ---------------------------------------------------
    dcn_coordinator: "str | None" = None  # host:port of process 0; setting
    dcn_num_processes: "int | None" = None  # these three joins the job via
    dcn_process_id: "int | None" = None  # parallel/mesh.init_multihost

    def __post_init__(self) -> None:
        self.data_dir = Path(self.data_dir)
        self.artifacts_dir = Path(self.artifacts_dir)
        if self.micro_batch_mode() not in ("off", "on", "auto"):
            raise ValueError(
                f"micro_batch must be a bool or 'off'/'on'/'auto', "
                f"got {self.micro_batch!r}"
            )

    def micro_batch_mode(self) -> str:
        """Normalized micro-batch mode ('off' | 'on' | 'auto'); bools are
        accepted for back-compat with the round-2 flag."""
        if isinstance(self.micro_batch, bool):
            return "on" if self.micro_batch else "off"
        return str(self.micro_batch)

    # Artifact locations (reference config.py:76,87,89 equivalents).
    @property
    def dnn_index_path(self) -> Path:
        return self.artifacts_dir / f"dnn_{self.dnn_model.value}_{self.index_type.value}.index.npz"

    @property
    def bovw_index_path(self) -> Path:
        return self.artifacts_dir / "bovw.index.npz"

    @property
    def bovw_pipeline_path(self) -> Path:
        return self.artifacts_dir / "bovw_pipeline.npz"

    @property
    def codebook_path(self) -> Path:
        return self.artifacts_dir / "codebook.npz"

    @property
    def dhash_store_path(self) -> Path:
        return self.artifacts_dir / "dhash.npz"

    @property
    def paths_file(self) -> Path:
        return self.artifacts_dir / "images.csv"  # id -> path sidecar

    @property
    def thumbnails_path(self) -> Path:
        return self.artifacts_dir / "thumbnails.npz"  # packed result thumbs

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Build a config from ``ISE_*`` environment variables + overrides."""
        kw = {}
        env = os.environ
        if "ISE_DATA_DIR" in env:
            kw["data_dir"] = Path(env["ISE_DATA_DIR"])
        if "ISE_ARTIFACTS_DIR" in env:
            kw["artifacts_dir"] = Path(env["ISE_ARTIFACTS_DIR"])
        if "ISE_METHOD" in env:
            kw["method"] = Method(env["ISE_METHOD"].lower())
        if "ISE_INDEX_TYPE" in env:
            kw["index_type"] = IndexType(env["ISE_INDEX_TYPE"].lower())
        if "ISE_DNN_MODEL" in env:
            kw["dnn_model"] = DnnModel(env["ISE_DNN_MODEL"].lower())
        if "ISE_NUM_CLUSTERS" in env:
            kw["num_clusters"] = int(env["ISE_NUM_CLUSTERS"])
        if "ISE_STORE_DTYPE" in env:
            # validate here like the CLI's argparse choices do: a typo must
            # fail at config construction, not after the whole corpus has
            # been embedded (VectorStore.build is the next consumer)
            dt = env["ISE_STORE_DTYPE"].lower()
            if dt not in STORE_DTYPES:
                raise ValueError(
                    f"ISE_STORE_DTYPE={dt!r} not in {sorted(STORE_DTYPES)}")
            kw["store_dtype"] = dt
        if "ISE_TORCH_WEIGHTS" in env:
            kw["torch_weights"] = Path(env["ISE_TORCH_WEIGHTS"])
        if "ISE_PQ_RERANK" in env:
            kw["pq_rerank"] = int(env["ISE_PQ_RERANK"])
        if "ISE_SHARDED" in env:
            kw["shard_devices"] = int(env["ISE_SHARDED"])  # 0 = all devices
        kw.update(overrides)
        return cls(**kw)
