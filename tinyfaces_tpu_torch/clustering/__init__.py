"""Template clustering of the port: k-medoids over GT box shapes (host
NumPy, as in the JAX package)."""

from tinyfaces_tpu_torch.clustering.cluster import (  # noqa: F401
    BACKENDS,
    centralize_bbox,
    compute_distances,
    compute_kmedoids,
    k_medoids,
    pam,
)
