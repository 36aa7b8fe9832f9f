from repro_torch.index.ann import AnnIndex, build_index, data_fingerprint
from repro_torch.index.build import BuildReport, IndexBuilder, capacity_assign_device
from repro_torch.index.incremental import PartialUpdate, admit_and_patch
from repro_torch.index.kmeans import capacity_assign, kmeans_centroids, kmeans_fit, lsh_init_centroids

__all__ = [
    "AnnIndex",
    "BuildReport",
    "IndexBuilder",
    "PartialUpdate",
    "admit_and_patch",
    "build_index",
    "capacity_assign",
    "capacity_assign_device",
    "data_fingerprint",
    "kmeans_centroids",
    "kmeans_fit",
    "lsh_init_centroids",
]
