"""The mesh layer: device meshes, row-sharded stores, the distributed top-k
merge, distributed k-means and the sharded IVF and IVF-PQ indexes
(parallel/mesh.py, topk.py, kmeans.py, ivf.py)."""
