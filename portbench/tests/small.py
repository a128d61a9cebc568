"""Sizes at which a CPU test drives a whole run of each cell: the cells'
own shapes, cut in rows, images and window so that a run takes seconds.
Each value overrides one key of the cell's configuration or mix."""

BACKBONE = {"arch": "resnet50", "stages": [3, 4, 6, 3], "image_size": 64,
            "embedding_dim": 2048, "dtype": "bfloat16"}
SERVED = {"config": {"rows": 4096, "backbone": BACKBONE,
                     "corpus": {"kind": "near_dup", "anchors": 16, "spread": [0.05, 1.0]}},
          "mix": {"rate_per_s": 15, "sample_requests": 8, "clients": 4}}
CELLS = {
    "exact-1m-d128-bf16.q4096": {"config": {"rows": 20000},
                                 "mix": {"queries_per_call": 64, "query_batches": 2,
                                         "sample_calls": 3}},
    "resnet50-flat-1m.open-mb8": SERVED,
    "resnet50-flat-1m.index-b64": {"config": SERVED["config"],
                                   "mix": {"batch_images": 8, "pool_batches": 2,
                                           "sample_rows": 8}},
}
SECONDS = 1.5
