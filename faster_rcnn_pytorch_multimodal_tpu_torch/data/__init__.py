"""Data (copied from the JAX package): the synthetic dataset, the KITTI,
Waymo and CADC databases (`datasets.get_db`), their augmentation, and the
batch loader with its prefetch thread and worker processes."""
