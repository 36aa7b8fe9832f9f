from repro_torch.metrics.neighborhood import exact_knn, map_stability, neighborhood_preservation
from repro_torch.metrics.triplet import random_triplet_accuracy

__all__ = ["exact_knn", "map_stability", "neighborhood_preservation", "random_triplet_accuracy"]
